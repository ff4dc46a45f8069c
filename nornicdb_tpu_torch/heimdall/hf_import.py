"""LLaMA-class decoders for Heimdall (counterpart of
``nornicdb_tpu/heimdall/hf_import.py``).

A LLaMA-faithful forward in float32 (RMSNorm, half-split rotary
embeddings, SwiGLU, grouped-query attention by repeating the key/value
heads, no biases) over a HF state dict carried across by
``import_hf_decoder_params`` (right-multiplied ``[in, out]`` weights, the
reference's tree). Generation re-runs the full prefill for every new
token, as the reference's does: ``generate_ids`` is that loop on token
ids, with no tokenizer, and ``HFDecoderModel`` wraps it with the model's
own tokenizer (``transformers`` is imported only there). Point
``NORNICDB_TPU_SLM_DIR`` at a local model directory and
``TorchGenerator`` serves it.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device


@dataclass(frozen=True)
class HFDecoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    max_position: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_word_embeddings: bool = False

    @staticmethod
    def from_hf_config(cfg: Dict[str, Any]) -> "HFDecoderConfig":
        return HFDecoderConfig(
            vocab_size=int(cfg["vocab_size"]),
            hidden_size=int(cfg["hidden_size"]),
            num_layers=int(cfg["num_hidden_layers"]),
            num_heads=int(cfg["num_attention_heads"]),
            num_kv_heads=int(cfg.get("num_key_value_heads",
                                     cfg["num_attention_heads"])),
            intermediate_size=int(cfg["intermediate_size"]),
            max_position=int(cfg.get("max_position_embeddings", 2048)),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            rms_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        )


def _f32(x, transpose: bool = False) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x.detach().to(torch.float32)
        return (t.T if transpose else t).contiguous()
    arr = np.asarray(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr.T if transpose else arr))


def import_hf_decoder_params(tensors: Dict[str, Any], cfg: HFDecoderConfig,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """A HF LLaMA-family state dict (numpy arrays or tensors) -> the
    decoder tree as float32 tensors on ``device``. Raises KeyError naming
    the missing tensor."""
    dev = resolve_device(device)
    pre = "model." if any(k.startswith("model.") for k in tensors) else ""

    def t(name: str, transpose: bool = False) -> torch.Tensor:
        full = pre + name
        if full not in tensors:
            raise KeyError(f"checkpoint missing tensor {full!r}")
        return _f32(tensors[full], transpose).to(dev)

    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        layers.append({
            "ln1": t(p + "input_layernorm.weight"),
            "ln2": t(p + "post_attention_layernorm.weight"),
            # torch Linear [out, in] -> right-multiply [in, out]
            "wq": t(p + "self_attn.q_proj.weight", transpose=True),
            "wk": t(p + "self_attn.k_proj.weight", transpose=True),
            "wv": t(p + "self_attn.v_proj.weight", transpose=True),
            "wo": t(p + "self_attn.o_proj.weight", transpose=True),
            "w_gate": t(p + "mlp.gate_proj.weight", transpose=True),
            "w_up": t(p + "mlp.up_proj.weight", transpose=True),
            "w_down": t(p + "mlp.down_proj.weight", transpose=True),
        })
    embed = t("embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in tensors:
        lm_head = embed.T
    else:
        lm_head = _f32(tensors["lm_head.weight"], transpose=True).to(dev)
    return {"embed": embed, "norm": t("norm.weight"), "lm_head": lm_head,
            "layers": layers}


def tree_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    out = [params["embed"], params["norm"], params["lm_head"]]
    for lp in params["layers"]:
        out.extend(lp[k] for k in sorted(lp))
    return out


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return (x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)) * g


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over [T, H, Dh], half-split (HF's ``rotate_half``)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs[None, :]  # [T, half]
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(cfg: HFDecoderConfig, params: Dict[str, Any],
            token_ids: torch.Tensor) -> torch.Tensor:
    """[T] ids -> [T, vocab] float32 logits (causal, full prefill)."""
    t = token_ids.shape[0]
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.hidden_size // h
    positions = torch.arange(t, device=token_ids.device)
    causal = positions[:, None] >= positions[None, :]
    x = params["embed"][token_ids]
    for lp in params["layers"]:
        y = _rms(x, lp["ln1"], cfg.rms_eps)
        q = _rope((y @ lp["wq"]).view(t, h, dh), positions, cfg.rope_theta)
        k = _rope((y @ lp["wk"]).view(t, kvh, dh), positions, cfg.rope_theta)
        v = (y @ lp["wv"]).view(t, kvh, dh)
        if kvh != h:  # grouped-query attention: repeat kv heads
            k = torch.repeat_interleave(k, h // kvh, dim=1)
            v = torch.repeat_interleave(v, h // kvh, dim=1)
        scores = torch.einsum("thd,shd->hts", q, k) / float(np.sqrt(dh))
        scores = scores.masked_fill(~causal[None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("hts,shd->thd", probs, v).reshape(t, cfg.hidden_size)
        x = x + attn @ lp["wo"]
        y = _rms(x, lp["ln2"], cfg.rms_eps)
        x = x + (F.silu(y @ lp["w_gate"]) * (y @ lp["w_up"])) @ lp["w_down"]
    x = _rms(x, params["norm"], cfg.rms_eps)
    return x @ params["lm_head"]


@torch.no_grad()
def generate_ids(cfg: HFDecoderConfig, params: Dict[str, Any], ids: List[int],
                 max_tokens: int = 64, temperature: float = 0.0, seed: int = 0,
                 eos: Optional[int] = None) -> List[int]:
    """Greedy (temperature 0) or sampled continuation of ``ids``, one
    full prefill per new token over the last ``max_position`` ids; stops
    before ``eos``. Sampling draws from ``np.random.default_rng(seed)``
    over the float32 softmax, as the reference does."""
    dev = params["embed"].device
    ids = list(ids)
    rng = np.random.default_rng(seed)
    out: List[int] = []
    for _ in range(max_tokens):
        window = torch.tensor(ids[-cfg.max_position:], dtype=torch.int64, device=dev)
        logits = forward(cfg, params, window)[-1].cpu().numpy()
        if temperature and temperature > 0:
            z = logits / temperature
            z = z - z.max()
            p = np.exp(z) / np.exp(z).sum()
            nxt = int(rng.choice(len(p), p=p))
        else:
            nxt = int(np.argmax(logits))
        if eos is not None and nxt == eos:
            break
        ids.append(nxt)
        out.append(nxt)
    return out


_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "model.npz")


def load_hf_decoder_dir(model_dir: str, device: DeviceLike = None):
    """(cfg, params on ``device``) from a local HF LLaMA-family model directory."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        cfg = HFDecoderConfig.from_hf_config(json.load(f))
    from nornicdb_tpu_torch.models.hf_import import read_checkpoint_tensors

    for fname in _WEIGHT_FILES:
        path = os.path.join(model_dir, fname)
        if os.path.exists(path):
            return cfg, import_hf_decoder_params(
                read_checkpoint_tensors(path), cfg, device)
    raise FileNotFoundError(
        f"no weight file in {model_dir!r} (looked for {_WEIGHT_FILES})")


class HFDecoderModel:
    """``DecoderModel``'s interface over imported LLaMA-class weights and
    the model's own tokenizer (``TorchGenerator`` serves it)."""

    def __init__(self, model_dir: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.params = load_hf_decoder_dir(model_dir, self.device)
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(
            model_dir, local_files_only=True)
        self._lock = threading.Lock()

    def param_bytes(self) -> int:
        return sum(int(v.numel()) * 4 for v in tree_leaves(self.params))

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0) -> str:
        ids: List[int] = self.tokenizer.encode(prompt)
        with self._lock:
            out = generate_ids(self.cfg, self.params, ids, max_tokens,
                               temperature, seed, self.tokenizer.eos_token_id)
        return self.tokenizer.decode(out)


def default_slm_dir() -> Optional[str]:
    """NORNICDB_TPU_SLM_DIR when it points at a loadable model dir."""
    d = os.environ.get("NORNICDB_TPU_SLM_DIR", "")
    if d and os.path.exists(os.path.join(d, "config.json")):
        return d
    return None
