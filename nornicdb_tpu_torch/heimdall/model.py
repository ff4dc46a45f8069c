"""The SLM decoder of Heimdall (counterpart of ``nornicdb_tpu/heimdall/model.py``).

A byte-level decoder-only transformer: pre-RMSNorm blocks, tanh-GELU MLP,
learned positions of length ``max_seq`` and an output head tied to the
token embedding. Parameters are float32; every forward computes in
bfloat16 in the reference's order of operations:

- the prefill sums ``embed[tok] + pos`` in float32 and rounds once to
  bf16, the decode step sums two bf16 rows;
- ``_rms_norm`` is ``x * g * rsqrt(mean(x * x) + 1e-6)`` in bf16;
- scores are divided by ``sqrt(dh)`` in bf16 and masked with ``-1e30``
  before a bf16 softmax taken in ``jax.nn.softmax``'s steps;
- logits come back in float32.

``forward_full`` is the one full-sequence forward: prefill and training
(``heimdall/train.py``) both call it, so their math cannot drift. The
decode keeps a ``[max_seq, D]`` key and value cache per layer and updates
it in place. Greedy decoding masks ``PAD`` and takes the first argmax;
sampling draws from a ``torch.Generator`` seeded from ``seed``, so it
cannot reproduce ``jax.random.categorical``'s draws (ROADMAP C32).
Attention here is plain PyTorch ops, as in the reference: the decoder
never reaches a Pallas kernel there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device

# byte-level vocab: 256 bytes + PAD/BOS/EOS
PAD, BOS, EOS = 256, 257, 258
VOCAB = 259
NEG = -1e30


@dataclass(frozen=True)
class DecoderConfig:
    vocab: int = VOCAB
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    max_seq: int = 512

    @staticmethod
    def tiny() -> "DecoderConfig":
        return DecoderConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128,
                             max_seq=128)


def encode_bytes(text: str, max_len: int) -> np.ndarray:
    ids = [BOS] + list(text.encode("utf-8"))[: max_len - 1]
    return np.asarray(ids, dtype=np.int32)


def decode_bytes(ids) -> str:
    bs = bytes(int(i) for i in ids if 0 <= int(i) < 256)
    return bs.decode("utf-8", errors="replace")


def init_params_numpy(cfg: DecoderConfig, seed: int = 0) -> Dict[str, Any]:
    """The reference's initial weights as float32 numpy arrays: the same
    ``default_rng`` draws in the same order, so bitwise equal."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return np.asarray(rng.standard_normal(shape, dtype=np.float32) * scale,
                          np.float32)

    ones = lambda: np.ones(cfg.d_model, np.float32)  # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": ones(),
            "ln2": ones(),
            "wq": w(cfg.d_model, cfg.d_model),
            "wk": w(cfg.d_model, cfg.d_model),
            "wv": w(cfg.d_model, cfg.d_model),
            "wo": w(cfg.d_model, cfg.d_model),
            "w1": w(cfg.d_model, cfg.d_ff),
            "w2": w(cfg.d_ff, cfg.d_model),
        })
    return {
        "embed": w(cfg.vocab, cfg.d_model, scale=0.02),
        "pos": w(cfg.max_seq, cfg.d_model, scale=0.02),
        "ln_f": ones(),
        "layers": layers,
    }


def params_to_device(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A decoder tree of arrays (numpy, JAX or tensors) as float32
    tensors on ``device``."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(device)

    return {
        "embed": t(tree["embed"]),
        "pos": t(tree["pos"]),
        "ln_f": t(tree["ln_f"]),
        "layers": [{k: t(v) for k, v in lp.items()} for lp in tree["layers"]],
    }


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: float32 numpy arrays on the host."""
    def a(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)

    return {
        "embed": a(tree["embed"]),
        "pos": a(tree["pos"]),
        "ln_f": a(tree["ln_f"]),
        "layers": [{k: a(v) for k, v in lp.items()} for lp in tree["layers"]],
    }


def init_params(cfg: DecoderConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Initial weights on ``device`` (bitwise the reference's)."""
    return params_to_device(init_params_numpy(cfg, seed), resolve_device(device))


def leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """Every tensor of a decoder tree, in a fixed order."""
    out = [params["embed"], params["pos"], params["ln_f"]]
    for lp in params["layers"]:
        out.extend(lp[k] for k in sorted(lp))
    return out


def _bf16(params: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "embed": params["embed"].to(torch.bfloat16),
        "pos": params["pos"].to(torch.bfloat16),
        "ln_f": params["ln_f"].to(torch.bfloat16),
        "layers": [{k: v.to(torch.bfloat16) for k, v in lp.items()}
                   for lp in params["layers"]],
    }


def _rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * g * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s steps in x's type: exp of the shifted scores,
    then one division by their sum (nearer the reference in bf16 than
    ``torch.softmax``, which rounds once from float32)."""
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _attn(cfg: DecoderConfig, lp, x, k_cache, v_cache, pos_mask):
    """x: [..., T, D]; caches: [..., S, D]; pos_mask: [..., T, S] allowed."""
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    q = (x @ lp["wq"]).unflatten(-1, (h, dh))
    k = k_cache.unflatten(-1, (h, dh))
    v = v_cache.unflatten(-1, (h, dh))
    # sqrt(dh) rounded to x's type first, as the reference divides
    root = float(torch.tensor(float(np.float32(np.sqrt(dh))), dtype=x.dtype))
    scores = torch.einsum("...thd,...shd->...hts", q, k) / root
    scores = scores.masked_fill(~pos_mask.unsqueeze(-3), NEG)
    probs = _softmax(scores)
    out = torch.einsum("...hts,...shd->...thd", probs, v).flatten(-2)
    return out @ lp["wo"]


def _block(cfg, lp, x, k_cache, v_cache, pos_mask):
    normed = _rms_norm(x, lp["ln1"])
    x = x + _attn(cfg, lp, normed, k_cache, v_cache, pos_mask)
    normed = _rms_norm(x, lp["ln2"])
    return x + F.gelu(normed @ lp["w1"], approximate="tanh") @ lp["w2"]


def forward_full(cfg: DecoderConfig, params, tokens: torch.Tensor,
                 key_valid: torch.Tensor):
    """The shared full-sequence forward of prefill and training. tokens:
    [..., S] integer ids (S = max_seq); key_valid: [..., S] bool (which key
    positions are real). Returns (float32 logits [..., S, V], caches, a
    list of (k, v) [..., S, D] in bf16 per layer)."""
    s = cfg.max_seq
    x = (params["embed"][tokens] + params["pos"]).to(torch.bfloat16)
    positions = torch.arange(s, device=tokens.device)
    causal = positions[None, :] <= positions[:, None]  # [T, S]
    diag = positions[None, :] == positions[:, None]
    mask = causal & (key_valid.unsqueeze(-2) | diag)
    caches = []
    for lp in params["layers"]:
        lp16 = {k: v.to(torch.bfloat16) for k, v in lp.items()}
        k = _rms_norm(x, lp16["ln1"]) @ lp16["wk"]
        v = _rms_norm(x, lp16["ln1"]) @ lp16["wv"]
        x = _block(cfg, lp16, x, k, v, mask)
        caches.append((k, v))
    x = _rms_norm(x, params["ln_f"].to(torch.bfloat16))
    logits = x @ params["embed"].to(torch.bfloat16).T
    return logits.float(), caches


def prefill(cfg: DecoderConfig, params, tokens: torch.Tensor, length: int):
    """tokens: [max_seq] ids (PAD-padded); length: the prompt's length.
    Returns (logits at the last prompt position [V], caches)."""
    key_valid = torch.arange(cfg.max_seq, device=tokens.device) < length
    logits, caches = forward_full(cfg, params, tokens, key_valid)
    return logits[length - 1], caches


def _sample(logits: torch.Tensor, temperature: float,
            gen: Optional[torch.Generator]) -> int:
    logits = logits.clone()
    logits[PAD] = NEG
    if temperature <= 1e-6:
        return int(torch.argmax(logits))
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


@torch.no_grad()
def generate_tokens(cfg: DecoderConfig, params, tokens: torch.Tensor, length: int,
                    max_new: int, temperature: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """Up to ``max_new`` tokens after the prompt, EOS-padded once EOS (or
    the last position) is reached: [max_new] int64 on the host. The
    reference always runs ``max_new`` steps; from the step that emits
    EOS on, every token it emits is EOS, so this loop stops there and
    pads: the output is the same."""
    dev = tokens.device
    s = cfg.max_seq
    logits, caches = prefill(cfg, params, tokens, length)
    caches = [(k.clone(), v.clone()) for k, v in caches]
    p16 = _bf16(params)
    positions = torch.arange(s, device=dev)
    gen = None
    if temperature > 1e-6:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = torch.full((max_new,), EOS, dtype=torch.int64)
    pos = length
    for i in range(max_new):
        tok = _sample(logits, temperature, gen)
        out[i] = tok
        if tok == EOS or pos >= s - 1:
            break
        # one token at position pos
        x = (p16["embed"][tok] + p16["pos"][pos])[None, :]
        mask = positions[None, :] <= pos  # [1, S]
        for lp, (k_c, v_c) in zip(p16["layers"], caches):
            normed = _rms_norm(x, lp["ln1"])
            k_c[pos] = (normed @ lp["wk"])[0]
            v_c[pos] = (normed @ lp["wv"])[0]
            x = _block(cfg, lp, x, k_c, v_c, mask)
        x = _rms_norm(x, p16["ln_f"])
        logits = (x[0] @ p16["embed"].T).float()
        pos += 1
    return out


class DecoderModel:
    """Host-side wrapper: tokenize -> device generate -> detokenize."""

    def __init__(self, cfg: Optional[DecoderConfig] = None,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg or DecoderConfig.tiny()
        tree = params if params is not None else init_params_numpy(self.cfg, seed)
        self.params = params_to_device(tree, self.device)

    def param_bytes(self) -> int:
        """4 bytes an element, as the reference counts (the Manager's
        budget reads it)."""
        return int(sum(x.numel() * 4 for x in leaves(self.params)))

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0) -> str:
        ids = encode_bytes(prompt, self.cfg.max_seq)
        length = len(ids)
        padded = np.full(self.cfg.max_seq, PAD, np.int64)
        padded[:length] = ids
        max_new = min(max_tokens, self.cfg.max_seq - length)
        if max_new <= 0:
            return ""
        toks = generate_tokens(
            self.cfg, self.params, torch.from_numpy(padded).to(self.device),
            length, int(max_new), float(temperature), seed).numpy()
        eos = np.nonzero(toks == EOS)[0]
        if eos.size:
            toks = toks[: eos[0]]
        return decode_bytes(toks)
