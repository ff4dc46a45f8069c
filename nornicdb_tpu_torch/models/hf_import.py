"""HuggingFace encoder checkpoints -> the port (counterpart of
``nornicdb_tpu/models/hf_import.py``).

- ``HFEncoder``: the BERT/RoBERTa computation graph (XLM-R is RoBERTa's,
  bge-m3's backbone): post-LayerNorm blocks, token-type embeddings, erf
  GELU, RoBERTa's pad-offset position ids, CLS or masked-mean pooling,
  L2 normalization; float32 throughout. Its attention is an einsum with
  an additive ``finfo(float32).min`` bias and a float32 softmax, as the
  reference's is: it never reaches the B2 kernel there either.
- ``import_hf_params``: a HF state dict (``bert.*`` / ``roberta.*`` /
  ``model.*`` / bare names; safetensors, torch ``.bin`` or ``.npz``) ->
  ``HFEncoder``'s ``state_dict``. Linear weights keep torch's
  ``[out, in]``, so the map is by name; a missing tensor raises
  ``KeyError`` naming it, as the reference's does.
- ``load_hf_model_dir``, ``HFEncoderEmbedder`` (the model's own tokenizer
  from local files; ``transformers`` is imported only when one is built),
  ``default_model_dir`` (``NORNICDB_TPU_MODEL_DIR``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.similarity import l2_normalize


@dataclass(frozen=True)
class HFEncoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # 'bert' = arange position ids; 'roberta' (XLM-R, bge-m3 backbone) =
    # cumsum-of-mask ids offset past the padding idx
    arch: str = "bert"
    pooling: str = "mean"  # 'mean' | 'cls'

    @staticmethod
    def from_hf_config(cfg: Dict[str, Any]) -> "HFEncoderConfig":
        model_type = cfg.get("model_type", "bert")
        arch = "roberta" if model_type in (
            "roberta", "xlm-roberta", "camembert") else "bert"
        return HFEncoderConfig(
            vocab_size=int(cfg["vocab_size"]),
            hidden_size=int(cfg["hidden_size"]),
            num_layers=int(cfg["num_hidden_layers"]),
            num_heads=int(cfg["num_attention_heads"]),
            intermediate_size=int(cfg["intermediate_size"]),
            max_position_embeddings=int(cfg["max_position_embeddings"]),
            type_vocab_size=int(cfg.get("type_vocab_size", 2)),
            layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-12)),
            pad_token_id=int(cfg.get("pad_token_id", 0) or 0),
            arch=arch,
        )


class _Layer(nn.Module):
    def __init__(self, cfg: HFEncoderConfig):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))
        self.attn_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp_up = nn.Linear(d, m)
        self.mlp_down = nn.Linear(m, d)
        self.mlp_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class HFEncoder(nn.Module):
    """BERT/RoBERTa-faithful encoder: token ids -> pooled, L2-normalized
    embedding [B, hidden] (post-LN, unlike the port's ``Encoder``)."""

    def __init__(self, cfg: HFEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.tok_embed = nn.Embedding(cfg.vocab_size, d)
        self.pos_embed = nn.Embedding(cfg.max_position_embeddings, d)
        self.type_embed = nn.Embedding(max(cfg.type_vocab_size, 1), d)
        self.emb_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))

    def forward(self, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = token_ids != cfg.pad_token_id
        mask = attention_mask.to(torch.int64)
        if cfg.arch == "roberta":
            positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        else:
            positions = torch.arange(token_ids.shape[1], device=token_ids.device)
            positions = positions[None, :].expand_as(token_ids)
        x = (self.tok_embed(token_ids) + self.pos_embed(positions)
             + self.type_embed(torch.zeros_like(token_ids)))
        x = self.emb_ln(x)
        neg = torch.finfo(torch.float32).min
        bias = torch.where(attention_mask.bool()[:, None, None, :],
                           torch.zeros((), device=x.device),
                           torch.full((), neg, device=x.device))
        b, s, d = x.shape
        h = cfg.num_heads
        scale = (d // h) ** -0.5
        for lp in self.layers:
            q, k, v = (layer(x).view(b, s, h, d // h) for layer in (lp.q, lp.k, lp.v))
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias
            w = torch.softmax(logits, dim=-1)
            a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, d)
            x = lp.attn_ln(x + lp.o(a))
            m = lp.mlp_down(F.gelu(lp.mlp_up(x)))  # HF 'gelu' is erf-based
            x = lp.mlp_ln(x + m)
        if cfg.pooling == "cls":
            pooled = x[:, 0, :]
        else:
            mf = attention_mask[:, :, None].float()
            pooled = (x * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)
        return l2_normalize(pooled)


# -- state-dict import -----------------------------------------------------

_PREFIXES = ("bert.", "roberta.", "model.", "encoder.model.", "")


def _strip_prefix(names: Sequence[str]) -> str:
    for pre in _PREFIXES:
        if pre and sum(1 for n in names if n.startswith(pre)) > len(names) // 2:
            return pre
    return ""


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def import_hf_params(tensors: Dict[str, Any],
                     cfg: HFEncoderConfig) -> Dict[str, torch.Tensor]:
    """A HF BERT/RoBERTa state dict -> ``HFEncoder``'s ``state_dict``
    (float32, on the CPU). Raises KeyError naming a missing HF tensor."""
    pre = _strip_prefix(list(tensors))

    def t(name: str) -> torch.Tensor:
        full = pre + name
        if full not in tensors:
            raise KeyError(f"checkpoint missing tensor {full!r}")
        return _f32(tensors[full])

    sd: Dict[str, torch.Tensor] = {}

    def linear(ours: str, hf: str) -> None:
        sd[ours + ".weight"] = t(hf + ".weight")
        sd[ours + ".bias"] = t(hf + ".bias")

    sd["tok_embed.weight"] = t("embeddings.word_embeddings.weight")
    sd["pos_embed.weight"] = t("embeddings.position_embeddings.weight")
    type_name = "embeddings.token_type_embeddings.weight"
    sd["type_embed.weight"] = (
        t(type_name) if pre + type_name in tensors
        else torch.zeros(max(cfg.type_vocab_size, 1), cfg.hidden_size))
    linear("emb_ln", "embeddings.LayerNorm")
    for i in range(cfg.num_layers):
        hf, ours = f"encoder.layer.{i}", f"layers.{i}"
        linear(f"{ours}.q", f"{hf}.attention.self.query")
        linear(f"{ours}.k", f"{hf}.attention.self.key")
        linear(f"{ours}.v", f"{hf}.attention.self.value")
        linear(f"{ours}.o", f"{hf}.attention.output.dense")
        linear(f"{ours}.attn_ln", f"{hf}.attention.output.LayerNorm")
        linear(f"{ours}.mlp_up", f"{hf}.intermediate.dense")
        linear(f"{ours}.mlp_down", f"{hf}.output.dense")
        linear(f"{ours}.mlp_ln", f"{hf}.output.LayerNorm")
    return sd


def read_checkpoint_tensors(path: str) -> Dict[str, np.ndarray]:
    """name -> array from ``.safetensors``, torch ``.bin``/``.pt``, or ``.npz``."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    if path.endswith(".npz"):
        return {k: v for k, v in np.load(path).items()}
    # torch pickle (weights_only=True: no arbitrary code execution)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "model.npz")


def load_hf_model_dir(model_dir: str, pooling: str = "mean"):
    """(cfg, state_dict) from a local HF model directory."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        cfg = HFEncoderConfig.from_hf_config(json.load(f))
    if pooling != cfg.pooling:
        cfg = dataclasses.replace(cfg, pooling=pooling)
    for fname in _WEIGHT_FILES:
        path = os.path.join(model_dir, fname)
        if os.path.exists(path):
            return cfg, import_hf_params(read_checkpoint_tensors(path), cfg)
    raise FileNotFoundError(
        f"no weight file in {model_dir!r} (looked for {_WEIGHT_FILES})")


def build_encoder(cfg: HFEncoderConfig, state_dict: Dict[str, torch.Tensor],
                  device: DeviceLike = None) -> HFEncoder:
    """An ``HFEncoder`` holding ``state_dict`` on ``device``, in eval mode
    (built on the meta device, so no random weights are drawn first)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = HFEncoder(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.to(dev).eval()


class HFEncoderEmbedder:
    """``embed``/``embed_batch`` over an imported HF encoder with the
    model's own tokenizer (``AutoTokenizer`` over local files only: it
    never downloads). Drop-in for the ``Embedder`` protocol."""

    def __init__(self, model_dir: str, pooling: str = "mean",
                 max_batch: int = 16, max_len: int = 512,
                 device: DeviceLike = None):
        cfg, state = load_hf_model_dir(model_dir, pooling=pooling)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_encoder(cfg, state, self.device)
        self.dims = cfg.hidden_size
        self.max_batch = max_batch
        self.max_len = min(max_len, cfg.max_position_embeddings - 2)
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(
            model_dir, local_files_only=True)
        self._lock = threading.Lock()

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[List[float]] = []
        for start in range(0, len(texts), self.max_batch):
            chunk = list(texts[start:start + self.max_batch])
            enc = self.tokenizer(
                chunk, padding=True, truncation=True,
                max_length=self.max_len, return_tensors="np")
            ids = torch.from_numpy(enc["input_ids"].astype(np.int64)).to(self.device)
            mask = torch.from_numpy(enc["attention_mask"].astype(bool)).to(self.device)
            with self._lock, torch.inference_mode():
                vecs = self.model(ids, mask)
            out.extend(vecs.float().cpu().numpy().tolist())
        return out

    def embed(self, text: str) -> List[float]:
        return self.embed_batch([text])[0]


def default_model_dir() -> Optional[str]:
    """NORNICDB_TPU_MODEL_DIR when it points at a loadable model dir."""
    d = os.environ.get("NORNICDB_TPU_MODEL_DIR", "")
    if d and os.path.exists(os.path.join(d, "config.json")):
        return d
    return None
