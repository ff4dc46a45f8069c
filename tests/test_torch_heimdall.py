"""Heimdall (``nornicdb_tpu_torch/heimdall``) against the JAX package's on the
same inputs, on the CPU.

Tolerances:
- ``init_params``, ``encode_corpus``, ``encode_bytes``: bitwise.
- ``forward_full``/``prefill``: both packages compute in bf16, rounding at
  other places, so logits on the committed tiny checkpoint stay within
  ``LOGIT_ATOL`` = 0.25 of the reference's (measured 0.125 on a logit scale
  of ~12.8) and key/value caches within ``CACHE_ATOL`` = 0.1 (measured
  0.047). Greedy tokens are compared one by one only where the
  reference's top-2 margin exceeds ``LOGIT_ATOL``.
- Greedy ``DecoderModel.generate``: equal strings on the five first corpus
  lines and their first halves.
- Training: bf16 gradients differ in their last bits, and Adam's first
  steps move each weight by about the rate times the gradient's sign, so
  a weight whose gradient is near zero may move the other way. One and
  three ``train`` steps: every loss within ``LOSS_ATOL`` = 2e-3, every
  weight within 2 x the rate x the steps, and at least 95% (one step) /
  60% (three steps) of the weights within 1e-4 of the reference's. The
  optimizer alone, on equal gradients, matches ``optax.adam`` within 1e-6.
- Sampling (temperature > 0) draws from a ``torch.Generator``, so it
  cannot give ``jax.random.categorical``'s tokens (ROADMAP C32): pinned as
  seeded and bounded, not as equal.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu import heimdall as jh
from nornicdb_tpu.heimdall import model as jm
from nornicdb_tpu.heimdall import train as jt
from nornicdb_tpu_torch import heimdall as th
from nornicdb_tpu_torch.heimdall import model as tm
from nornicdb_tpu_torch.heimdall import train as tt

torch.set_num_threads(1)

LOGIT_ATOL = 0.25
CACHE_ATOL = 0.1
LOSS_ATOL = 2e-3
PROMPTS = jt.DEFAULT_CORPUS[:5] + [" ".join(p.split()[: len(p.split()) // 2])
                                  for p in jt.DEFAULT_CORPUS[:5]]
CPU = torch.device("cpu")


def _np_tree(p):
    return {"embed": np.asarray(p["embed"]), "pos": np.asarray(p["pos"]),
            "ln_f": np.asarray(p["ln_f"]),
            "layers": [{k: np.asarray(v) for k, v in lp.items()} for lp in p["layers"]]}


def _flat(tree):
    out = {"embed": tree["embed"], "pos": tree["pos"], "ln_f": tree["ln_f"]}
    for i, lp in enumerate(tree["layers"]):
        out.update({f"layer{i}.{k}": v for k, v in lp.items()})
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def tiny():
    cfg_j, params_j = jt.load_params(jt.default_checkpoint_path())
    cfg = tm.DecoderConfig(**cfg_j.__dict__)
    _, tree = tt.load_params(tt.default_checkpoint_path())
    return cfg_j, params_j, cfg, tree


def _padded(cfg, text):
    ids = jm.encode_bytes(text, cfg.max_seq)
    padded = np.full(cfg.max_seq, jm.PAD, np.int32)
    padded[: len(ids)] = ids
    return padded, len(ids)


# -- model.py --------------------------------------------------------------


@pytest.mark.parametrize("cfg_name,seed", [("tiny", 0), ("tiny", 7), ("default", 3)])
def test_init_params_bitwise(cfg_name, seed):
    cj = jm.DecoderConfig.tiny() if cfg_name == "tiny" else jm.DecoderConfig()
    ct = tm.DecoderConfig(**cj.__dict__)
    want = _flat(_np_tree(jm.init_params(cj, seed)))
    got = _flat(tm.init_params(ct, seed, device="cpu"))
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("text", ["", "héllo wörld", "x" * 300, "vector search"])
def test_byte_codec_matches(text):
    for max_len in (8, 128, 512):
        assert np.array_equal(tm.encode_bytes(text, max_len), jm.encode_bytes(text, max_len))
    ids = list(range(250, 262)) + list(text.encode("utf-8"))
    assert tm.decode_bytes(ids) == jm.decode_bytes(ids)


def test_encode_corpus_bitwise():
    for cfg in (jm.DecoderConfig.tiny(), jm.DecoderConfig(max_seq=16)):
        want = jt.encode_corpus(jt.DEFAULT_CORPUS + ["é" * 40], cfg)
        got = tt.encode_corpus(tt.DEFAULT_CORPUS + ["é" * 40], tm.DecoderConfig(**cfg.__dict__))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tt.DEFAULT_CORPUS == jt.DEFAULT_CORPUS


@pytest.mark.parametrize("line", jt.DEFAULT_CORPUS)
def test_forward_full_and_prefill_match(tiny, line):
    cfg_j, params_j, cfg, tree = tiny
    padded, length = _padded(cfg, line)
    lj, cj = jm.forward_full(cfg_j, params_j, jnp.asarray(padded),
                             jnp.arange(cfg.max_seq) < length)
    params = tm.params_to_device(tree, CPU)
    lt, ct = tm.forward_full(cfg, params, torch.from_numpy(padded).long(),
                             torch.arange(cfg.max_seq) < length)
    assert lt.dtype == torch.float32 and lt.shape == (cfg.max_seq, cfg.vocab)
    assert np.abs(np.asarray(lj)[:length] - lt.numpy()[:length]).max() <= LOGIT_ATOL
    for (kj, vj), (kt, vt) in zip(cj, ct):
        assert kt.dtype == torch.bfloat16
        for a, b in ((kj, kt), (vj, vt)):
            assert np.abs(np.asarray(a, np.float32)[:length]
                          - b.float().numpy()[:length]).max() <= CACHE_ATOL
    pj, _ = jm.prefill(cfg_j, params_j, jnp.asarray(padded), jnp.asarray(length))
    pt, _ = tm.prefill(cfg, params, torch.from_numpy(padded).long(), length)
    assert np.abs(np.asarray(pj) - pt.numpy()).max() <= LOGIT_ATOL


@pytest.mark.parametrize("line", jt.DEFAULT_CORPUS)
def test_teacher_forced_tokens_match_where_margins_allow(tiny, line):
    cfg_j, params_j, cfg, tree = tiny
    padded, length = _padded(cfg, line)
    lj, _ = jm.forward_full(cfg_j, params_j, jnp.asarray(padded), jnp.arange(cfg.max_seq) < length)
    lt, _ = tm.forward_full(cfg, tm.params_to_device(tree, CPU), torch.from_numpy(padded).long(),
                            torch.arange(cfg.max_seq) < length)
    lj = np.asarray(lj)[:length].copy()
    lt = lt.numpy()[:length].copy()
    lj[:, jm.PAD] = lt[:, jm.PAD] = -1e30
    top2 = np.sort(lj, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LOGIT_ATOL
    assert clear.sum() >= length // 2
    assert np.array_equal(lj[clear].argmax(1), lt[clear].argmax(1))


@pytest.mark.parametrize("prompt", PROMPTS)
def test_greedy_generate_equal_strings(tiny, prompt):
    cfg_j, params_j, cfg, tree = tiny
    want = jm.DecoderModel(cfg_j, params_j).generate(prompt, max_tokens=64)
    got = tm.DecoderModel(cfg, tree, device="cpu").generate(prompt, max_tokens=64)
    assert got == want


def test_half_prompts_complete_the_corpus(tiny):
    _, _, cfg, tree = tiny
    m = tm.DecoderModel(cfg, tree, device="cpu")
    outs = [m.generate(p, max_tokens=64) for p in PROMPTS[5:]]
    assert all(outs) and "tpu" in m.generate("vector search runs on", 40)


@pytest.mark.parametrize("max_new", [1, 5, 40])
def test_generate_tokens_eos_padding_matches(tiny, max_new):
    """The port stops at EOS and pads; the reference runs every step and
    emits EOS after the first: the same array."""
    cfg_j, params_j, cfg, tree = tiny
    padded, length = _padded(cfg, jt.DEFAULT_CORPUS[3][:20])
    want = np.asarray(jm.generate_tokens(cfg_j, params_j, jnp.asarray(padded), jnp.asarray(length),
                                         max_new, 0.0, jax.random.PRNGKey(0)))
    got = tm.generate_tokens(cfg, tm.params_to_device(tree, CPU), torch.from_numpy(padded).long(),
                             length, max_new)
    assert got.shape == (max_new,) and np.array_equal(got.numpy(), want)


def test_generate_tokens_at_the_last_position(tiny):
    cfg_j, params_j, cfg, tree = tiny
    padded, _ = _padded(cfg, "y" * 200)  # a full window: length == max_seq
    want = np.asarray(jm.generate_tokens(cfg_j, params_j, jnp.asarray(padded),
                                         jnp.asarray(cfg.max_seq), 4, 0.0, jax.random.PRNGKey(0)))
    got = tm.generate_tokens(cfg, tm.params_to_device(tree, CPU), torch.from_numpy(padded).long(),
                             cfg.max_seq, 4)
    assert np.array_equal(got.numpy(), want) and (want[1:] == jm.EOS).all()


@pytest.mark.parametrize("prompt,max_tokens", [("z" * 127, 10), ("z" * 400, 10), ("hi", 0),
                                               ("hi", -3)])
def test_generate_edge_cases_answer_empty(tiny, prompt, max_tokens):
    cfg_j, params_j, cfg, tree = tiny
    want = jm.DecoderModel(cfg_j, params_j).generate(prompt, max_tokens=max_tokens)
    got = tm.DecoderModel(cfg, tree, device="cpu").generate(prompt, max_tokens=max_tokens)
    assert got == want == ""


def test_generate_respects_max_tokens(tiny):
    _, _, cfg, tree = tiny
    m = tm.DecoderModel(cfg, tree, device="cpu")
    for n in (1, 3, 8):
        assert len(m.generate("x", max_tokens=n, temperature=1.0, seed=3).encode(
            "utf-8", errors="replace")) <= 4 * n


def test_sampling_is_seeded_not_jax_bitwise(tiny):
    """C32: temperature > 0 draws from a torch.Generator seeded from
    ``seed``; the same seed gives the same text."""
    _, _, cfg, tree = tiny
    m = tm.DecoderModel(cfg, tree, device="cpu")
    a = m.generate("the graph", max_tokens=24, temperature=0.8, seed=5)
    assert a == m.generate("the graph", max_tokens=24, temperature=0.8, seed=5)
    others = {m.generate("the graph", max_tokens=24, temperature=5.0, seed=s) for s in range(4)}
    assert len(others) > 1


@pytest.mark.parametrize("which", ["tiny_checkpoint", "default_random", "tiny_random"])
def test_param_bytes_matches(tiny, which):
    if which == "tiny_checkpoint":
        cfg_j, params_j, cfg, tree = tiny
        want = jm.DecoderModel(cfg_j, params_j).param_bytes()
        got = tm.DecoderModel(cfg, tree, device="cpu").param_bytes()
    else:
        cj = jm.DecoderConfig() if which == "default_random" else jm.DecoderConfig.tiny()
        want = jm.DecoderModel(cj).param_bytes()
        got = tm.DecoderModel(tm.DecoderConfig(**cj.__dict__), device="cpu").param_bytes()
    assert got == want


def test_decoder_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tm.DecoderModel(), lambda: tm.init_params(tm.DecoderConfig.tiny()),
                 lambda: th.TorchGenerator(),
                 lambda: tt.train(tt.DEFAULT_CORPUS, steps=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- train.py --------------------------------------------------------------

SMALL = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match(steps):
    cj = jm.DecoderConfig(**SMALL)
    pj, lj = jt.train(jt.DEFAULT_CORPUS, cj, steps=steps, seed=1)
    losses = []
    pt, lt = tt.train(tt.DEFAULT_CORPUS, tm.DecoderConfig(**SMALL), steps=steps, seed=1,
                      device="cpu", losses=losses)
    assert len(losses) == steps and abs(lt - lj) <= LOSS_ATOL
    # the reference's per-step losses, recomputed along its own run
    want_first = float(jt._loss_fn(cj, jm.init_params(cj, 1), jnp.asarray(
        jt.encode_corpus(jt.DEFAULT_CORPUS, cj)[np.random.default_rng(1).integers(0, 8, 8)])))
    assert abs(losses[0] - want_first) <= LOSS_ATOL
    a, b = _flat(_np_tree(pj)), _flat(pt)
    close = np.concatenate([(np.abs(a[k] - b[k]) <= 1e-4).ravel() for k in a])
    assert close.mean() >= (0.95 if steps == 1 else 0.6)
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 2 * 3e-3 * steps + 1e-6, k


def test_adam_matches_optax_on_equal_gradients():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 30.0)]
    opt = optax.adam(3e-3)
    pj, state = jnp.asarray(w), None
    state = opt.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(w.copy()))
    topt = torch.optim.Adam([pt], lr=3e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        topt.step()
    assert np.abs(np.asarray(pj) - pt.detach().numpy()).max() <= 1e-6


def test_training_reduces_loss():
    cfg = tm.DecoderConfig(**SMALL)
    _, l10 = tt.train(tt.DEFAULT_CORPUS, cfg, steps=10, seed=1, device="cpu")
    _, l80 = tt.train(tt.DEFAULT_CORPUS, cfg, steps=80, seed=1, device="cpu")
    assert l80 < l10


def test_trained_checkpoint_beats_random_loss(tiny):
    _, _, cfg, tree = tiny
    data = torch.from_numpy(tt.encode_corpus(tt.DEFAULT_CORPUS, cfg).astype(np.int64))
    with torch.no_grad():
        trained = float(tt._loss_fn(cfg, tm.params_to_device(tree, CPU), data))
        rand = float(tt._loss_fn(cfg, tm.init_params(cfg, 5, device="cpu"), data))
    cfg_j, params_j, _, _ = tiny
    want = float(jt._loss_fn(cfg_j, params_j, jnp.asarray(tt.encode_corpus(tt.DEFAULT_CORPUS, cfg))))
    assert abs(trained - want) <= LOSS_ATOL and trained < 0.5 * rand and trained < 2.0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_checkpoint(tmp_path, writer):
    cfg_j = jm.DecoderConfig(**SMALL)
    cfg = tm.DecoderConfig(**SMALL)
    path = str(tmp_path / "slm.npz")
    if writer == "port":
        params = tm.init_params(cfg, 4, device="cpu")
        tt.save_params(path, cfg, params)
        cfg2, back = jt.load_params(path)
        assert cfg2 == cfg_j
        want, got = _flat(params), _flat(_np_tree(back))
    else:
        params = jm.init_params(cfg_j, 4)
        jt.save_params(path, cfg_j, params)
        cfg2, back = tt.load_params(path)
        assert cfg2 == cfg
        want, got = _flat(_np_tree(params)), _flat(back)
    assert want.keys() == got.keys()
    assert all(np.array_equal(want[k], got[k]) for k in want)


def test_default_checkpoint_is_the_reference_file():
    assert tt.default_checkpoint_path() == jt.default_checkpoint_path()


# -- generators, Manager, tools, Bifrost: both packages -----------------------

PACKAGES = {"jax": jh, "torch": th}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_register_load_generate(pkg):
    h = PACKAGES[pkg]
    mgr = h.Manager()
    mgr.register(h.ModelSpec(name="m1", backend="echo", memory_bytes=100))
    r = mgr.generate("hello", model="m1")
    assert r.text == "echo: hello" and r.model == "m1" and mgr.models()[0].loaded


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_memory_budget_evicts(pkg):
    h = PACKAGES[pkg]
    mgr = h.Manager(memory_budget_bytes=150)
    mgr.register(h.ModelSpec(name="a", backend="echo", memory_bytes=100))
    mgr.register(h.ModelSpec(name="b", backend="echo", memory_bytes=100))
    mgr.load("a")
    mgr.load("b")
    specs = {s.name: s for s in mgr.models()}
    assert specs["b"].loaded and not specs["a"].loaded and mgr.memory_used == 100
    assert mgr.unload("b") and not mgr.unload("b") and mgr.memory_used == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_over_budget_model_rejected(pkg):
    h = PACKAGES[pkg]
    mgr = h.Manager(memory_budget_bytes=50)
    mgr.register(h.ModelSpec(name="big", backend="echo", memory_bytes=100))
    with pytest.raises(MemoryError, match="needs 100 bytes > budget 50"):
        mgr.load("big")
    with pytest.raises(KeyError):
        mgr.load("nope")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_unknown_backend_and_no_models(pkg):
    h = PACKAGES[pkg]
    mgr = h.Manager()
    with pytest.raises(RuntimeError, match="no models registered"):
        mgr.generate("x")
    mgr.register(h.ModelSpec(name="x", backend="mystery"))
    with pytest.raises(ValueError, match="unknown backend 'mystery'"):
        mgr.load("x")
    assert mgr._loading == {}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_concurrent_loads_build_once(pkg, monkeypatch):
    h = PACKAGES[pkg]
    mgr = h.Manager()
    mgr.register(h.ModelSpec(name="slow", backend="echo", memory_bytes=10))
    builds = []
    real = mgr._build

    def slow_build(spec):
        builds.append(spec.name)
        time.sleep(0.05)
        return real(spec)

    monkeypatch.setattr(mgr, "_build", slow_build)
    gens = []
    threads = [threading.Thread(target=lambda: gens.append(mgr.load("slow"))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert builds == ["slow"] and mgr.memory_used == 10 and len({id(g) for g in gens}) == 1


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_chat_renders_transcript(pkg):
    h = PACKAGES[pkg]
    mgr = h.Manager()
    echo = h.EchoGenerator()
    mgr.register(h.ModelSpec(name="e", backend="echo"))
    mgr._loaded["e"] = echo
    mgr._specs["e"].loaded = True
    mgr.chat([{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}],
             model="e")
    assert echo.calls == ["system: be brief\nuser: hi\nassistant:"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_rbac_check_runs(pkg):
    h = PACKAGES[pkg]
    seen = []

    def rbac(user):
        seen.append(user)
        raise PermissionError("nope")

    mgr = h.Manager(rbac_check=rbac)
    mgr.register(h.ModelSpec(name="e", backend="echo"))
    for call in (lambda: mgr.generate("x", model="e", user="alice"),
                 lambda: list(mgr.generate_stream("x", model="e", user="bob")),
                 lambda: mgr.generate_with_tools("x", None, model="e", user="carol")):
        with pytest.raises(PermissionError):
            call()
    assert seen == ["alice", "bob", "carol"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_plugin_transforms_output_and_bifrost_publishes(pkg):
    h = PACKAGES[pkg]

    class Upper:
        def on_generate(self, prompt, text):
            return text.upper()

    mgr = h.Manager()
    mgr.bifrost = h.Bifrost()
    sub = mgr.bifrost.subscribe()
    mgr.register(h.ModelSpec(name="e", backend="echo"))
    mgr.register_plugin(Upper())
    mgr.register_plugin(object())  # no hook: ignored
    assert mgr.generate("hi", model="e").text == "ECHO: HI"
    msg = next(mgr.bifrost.events(sub, timeout=0.1))
    assert msg["event"] == "generation"
    assert msg["data"] == {"model": "e", "prompt_chars": 2, "output_chars": 8}
    assert "".join(mgr.generate_stream("abcdefghijklmnopq", model="e")) == \
        "echo: abcdefghijklmnopq"


def test_echo_generators_stream_alike():
    for cls in (jh.EchoGenerator, th.EchoGenerator):
        g = cls(replies=["first reply that is long"])
        assert list(g.generate_stream("p")) == ["first re", "ply that", " is long"]
        assert g.generate("q") == "echo: q" and g.calls == ["p", "q"]


def test_render_chat_matches():
    from nornicdb_tpu.heimdall.generators import render_chat as jr
    from nornicdb_tpu_torch.heimdall.generators import render_chat as tr

    msgs = [{"role": "system", "content": "s"}, {"content": "no role"}, {"role": "user"}]
    assert tr(msgs) == jr(msgs)


def test_torch_generator_defaults_to_the_committed_checkpoint():
    g = th.TorchGenerator(device="cpu")
    out = g.generate("vector search runs on", max_tokens=40)
    assert "tpu" in out
    assert out == jh.JAXGenerator().generate("vector search runs on", max_tokens=40)
    assert "".join(g.generate_stream("vector search runs on", max_tokens=40)) == out
    assert g.param_bytes() == jh.JAXGenerator().param_bytes()


def test_torch_generator_weight_resolution(tmp_path, monkeypatch):
    cfg = tm.DecoderConfig(**SMALL)
    # a pinned cfg means that model: random init, not the tiny checkpoint
    g = th.TorchGenerator(cfg=cfg, device="cpu")
    assert g.model.cfg == cfg
    # an explicit checkpoint loads, and must not fail silently
    path = str(tmp_path / "c.npz")
    tt.save_params(path, cfg, tm.init_params(cfg, 2, device="cpu"))
    assert th.TorchGenerator(checkpoint=path, device="cpu").model.cfg == cfg
    with pytest.raises(OSError):
        th.TorchGenerator(checkpoint=str(tmp_path / "missing.npz"), device="cpu")
    # explicit params beat everything
    params = tm.init_params_numpy(cfg, 9)
    g = th.TorchGenerator(cfg=cfg, params=params, device="cpu")
    assert np.array_equal(g.model.params["embed"].numpy(), params["embed"])
    # an SLM dir without weights fails loudly, in both packages
    (tmp_path / "slm").mkdir()
    (tmp_path / "slm" / "config.json").write_text(json.dumps(dict(
        vocab_size=10, hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=16)))
    monkeypatch.setenv("NORNICDB_TPU_SLM_DIR", str(tmp_path / "slm"))
    for make in (lambda: th.TorchGenerator(device="cpu"), lambda: jh.JAXGenerator()):
        with pytest.raises(FileNotFoundError, match="no weight file"):
            make()


@pytest.mark.parametrize("backend", ["torch", "jax"])
def test_manager_builds_the_torch_generator(backend):
    mgr = th.Manager()
    mgr.register(th.ModelSpec(name="slm", backend=backend, options={"device": "cpu"}))
    r = mgr.generate("vector search runs on", max_tokens=40)
    assert "tpu" in r.text and isinstance(mgr.load("slm"), th.TorchGenerator)
    assert mgr.memory_used == mgr.models()[0].memory_bytes == mgr.load("slm").param_bytes()
    assert th.ModelSpec(name="x").backend == "torch"


class _StubMcp:
    """The MCP surface ToolLoop drives, with the reference server's store
    and recall handlers (``nornicdb_tpu/api/mcp.py``) over either DB."""

    def __init__(self, db):
        self.db = db
        self._tools = {"store": {}, "recall": {}, "boom": {}}
        self._handlers = {"store": self._store, "recall": self._recall,
                          "boom": self._boom}

    def _store(self, args):
        node = self.db.store(args.get("content", ""), labels=args.get("labels"),
                             properties=args.get("properties"), node_id=args.get("node_id"))
        return {"id": node.id, "labels": node.labels}

    def _recall(self, args):
        return [{"id": h.get("id")} for h in self.db.recall(args.get("query", ""),
                                                           limit=int(args.get("limit", 10)))]

    def _boom(self, args):
        raise ValueError("bad args")


def _open(pkg):
    if pkg == "jax":
        from nornicdb_tpu.embed.embedder import HashEmbedder

        return nornicdb_tpu.open(embedder=HashEmbedder())
    from nornicdb_tpu_torch.embed.embedder import HashEmbedder

    return nornicdb_tpu_torch.open(device="cpu", embedder=HashEmbedder())


_SCRIPT = [
    'TOOL {"tool": "store", "args": {"content": "note one about graphs", "node_id": "n1"}}',
    'TOOL {"tool": "nope", "args": {}}',
    'TOOL {"tool": "boom", "args": {"x": 1}}',
    'TOOL {"tool": "recall", "args": {"query": "graphs note", "limit": 3}}',
    "TOOL {not json}",
]


def test_tool_loop_matches_the_reference():
    runs = []
    for pkg, h in PACKAGES.items():
        db = _open(pkg)
        try:
            mgr = h.Manager()
            mgr.bifrost = h.Bifrost()
            sub = mgr.bifrost.subscribe()
            mgr.register(h.ModelSpec(name="t", backend="echo", options={"replies": list(_SCRIPT)}))
            res = mgr.generate_with_tools("store then recall", _StubMcp(db), model="t",
                                          max_rounds=6)
            gen = mgr.load("t")
            events = [(m["event"], m["data"]) for m in mgr.bifrost.events(sub, timeout=0.05)]
            runs.append((res.text, res.tool_calls, gen.calls, events, db.storage.has_node("n1")))
        finally:
            db.close()
    assert runs[0] == runs[1]
    text, calls, prompts, events, stored = runs[1]
    assert text == "TOOL {not json}" and stored and len(calls) == 4
    assert calls[1]["result"]["error"].startswith("unknown tool")
    assert calls[2]["result"] == {"error": "ValueError: bad args"}
    assert calls[3]["result"][0]["id"] == "n1"
    assert [e for e, _ in events] == ["tool_call"] * 4
    assert "Available tools: boom, recall, store" in prompts[0]


@pytest.mark.parametrize("rounds", [1, 3])
def test_tool_loop_round_cap(rounds):
    got = []
    for h in PACKAGES.values():
        loop = h.ToolLoop(h.EchoGenerator(replies=['TOOL {"tool": "nope", "args": {}}'] * 10),
                          _StubMcp(None))
        text, calls = loop.run("x", max_rounds=rounds)
        got.append((text, calls))
    assert got[0] == got[1] and len(got[1][1]) == rounds


def test_bifrost_matches_the_reference():
    runs = []
    for h in PACKAGES.values():
        b = h.Bifrost(max_queue=2)
        s1, s2 = b.subscribe(), b.subscribe()
        fanout = [b.publish("e", {"i": i}) for i in range(5)]
        got = [m["data"]["i"] for m in b.events(s1, timeout=0.02)]
        b.unsubscribe(s2)
        after = b.publish("late", {"x": "y"})
        msg = next(b.events(s1, timeout=0.05))
        runs.append((fanout, got, after, b.events_published, h.Bifrost.sse(msg),
                     list(b.events(99, timeout=0.01))))
    assert runs[0] == runs[1]
    assert runs[1][1] == [3, 4] and runs[1][4] == 'event: late\ndata: {"x": "y"}\n\n'


# -- HTTP generators against a local mock server ----------------------------


@pytest.fixture(scope="module")
def mock_llm():
    from http.server import BaseHTTPRequestHandler, HTTPServer

    state = {"fail_next": 0, "seen": []}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            state["seen"].append((self.path, body, self.headers.get("Authorization")))
            if state["fail_next"] > 0:
                state["fail_next"] -= 1
                self.send_response(503)
                self.end_headers()
                return
            if self.path == "/v1/chat/completions":
                doc = {"choices": [{"message": {"content": "hi " + body["messages"][0]["content"]}}]}
            elif self.path == "/api/generate":
                doc = {"response": f"ollama {body['prompt']} {body['options']['num_predict']}"}
            elif self.path == "/bad/api/generate":
                self.send_response(400)
                self.end_headers()
                self.wfile.write(b"bad model")
                return
            else:
                self.send_response(404)
                self.end_headers()
                return
            payload = json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", state
    srv.shutdown()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_openai_and_ollama_generators(pkg, mock_llm):
    url, state = mock_llm
    h = PACKAGES[pkg]
    state["seen"].clear()
    oa = h.OpenAIGenerator(base_url=url + "/", model="m", api_key="sk-1")
    assert oa.name == "openai:m" and oa.generate("there", max_tokens=5) == "hi there"
    assert list(oa.generate_stream("you")) == ["hi you"]
    ol = h.OllamaGenerator(base_url=url, model="llama")
    assert ol.generate("p", max_tokens=7) == "ollama p 7"
    path, body, auth = state["seen"][0]
    assert path == "/v1/chat/completions" and auth == "Bearer sk-1" and body["max_tokens"] == 5
    state["fail_next"] = 1  # a 5xx retries once
    assert ol.generate("again", max_tokens=1) == "ollama again 1"
    mgr = h.Manager()
    mgr.register(h.ModelSpec(name="o", backend="ollama", options={"base_url": url, "model": "x"}))
    assert mgr.generate("q", model="o", max_tokens=2).text == "ollama q 2"


def test_http_generator_errors_match(mock_llm):
    from nornicdb_tpu.embed.http_providers import EmbedHTTPError as JErr
    from nornicdb_tpu_torch.errors import EmbedHTTPError as TErr

    url, _ = mock_llm
    msgs = []
    for h, err in ((jh, JErr), (th, TErr)):
        with pytest.raises(err) as e:
            h.OllamaGenerator(base_url=url + "/bad", model="x").generate("p")
        msgs.append(str(e.value))
        g = h.OllamaGenerator(base_url="http://127.0.0.1:1", model="x")
        g.retries, g.timeout = 0, 0.5
        with pytest.raises(err):
            g.generate("p")
    assert msgs[0] == msgs[1] and "HTTP 400: bad model" in msgs[1]


# -- the generator's consumers: LLMReranker and HeimdallQC ----------------------


def test_llm_reranker_over_both_generators_gives_the_same_order():
    """The committed checkpoint cannot produce an id list for a rerank
    prompt (it is longer than max_seq), so both fail open to the fused
    order; a scripted model reorders alike."""
    from nornicdb_tpu.search.rerank import LLMReranker as JR
    from nornicdb_tpu_torch.search.rerank import LLMReranker as TR

    cands = [{"id": f"c{i}", "properties": {"content": f"doc {i}"}} for i in range(5)]
    jm_, tm_ = jh.Manager(), th.Manager()
    jm_.register(jh.ModelSpec(name="slm", backend="jax"))
    tm_.register(th.ModelSpec(name="slm", backend="torch", options={"device": "cpu"}))
    want = JR(jm_, model="slm").rerank("doc", [dict(c) for c in cands], limit=4)
    got = TR(tm_, model="slm").rerank("doc", [dict(c) for c in cands], limit=4)
    assert got == want == cands[:4]
    for m, h in ((jm_, jh), (tm_, th)):
        m.register(h.ModelSpec(name="s", backend="echo",
                               options={"replies": ['ranked: ["c3", "c0"]']}))
    want = JR(jm_, model="s").rerank("doc", [dict(c) for c in cands])
    got = TR(tm_, model="s").rerank("doc", [dict(c) for c in cands])
    assert [c["id"] for c in got] == [c["id"] for c in want] == ["c3", "c0", "c1", "c2", "c4"]


def test_heimdall_qc_over_both_generators_decides_alike():
    from nornicdb_tpu.inference import HeimdallQC as JQC, Suggestion as JS
    from nornicdb_tpu.storage import MemoryEngine as JE, Node as JN
    from nornicdb_tpu_torch.inference import HeimdallQC as TQC, Suggestion as TS
    from nornicdb_tpu_torch.storage import MemoryEngine as TE, Node as TN

    runs = []
    for QC, S, E, N, gen in ((JQC, JS, JE, JN, jh.JAXGenerator()),
                             (TQC, TS, TE, TN, th.TorchGenerator(device="cpu"))):
        eng = E()
        for i in range(3):
            eng.create_node(N(id=f"q{i}", labels=["Doc"], properties={"content": f"doc {i}"}))
        sugs = [S("q0", f"q{i}", "SIMILAR_TO", c, "similarity") for i, c in ((1, 0.8), (2, 0.95))]
        qc = QC(gen.generate)
        approved = [(s.from_id, s.to_id) for s in qc.review_batch(eng, sugs)]
        runs.append((approved, qc.errors, qc.suggestions_out))
    # the tiny model cannot answer a review prompt longer than its window:
    # both fail open (all approved, one error counted)
    assert runs[0] == runs[1] == ([("q0", "q2"), ("q0", "q1")], 1, 2)
