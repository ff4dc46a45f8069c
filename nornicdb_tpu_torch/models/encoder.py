"""Transformer text encoder (counterpart of ``nornicdb_tpu/models/encoder.py``).

Matches the flax module layer for layer: LayerNorm eps 1e-6 computed in
float32, tanh-approximated GELU, learned positions of length
``max_len``, masked mean pooling, then L2 normalization (eps 1e-12).
Projections are plain ``nn.Linear`` computed in ``cfg.dtype``. Attention
is chosen at construction by ``cfg.use_flash_attention``, as the
reference's is: on (the default, every inference path) it goes through
the port's flash-attention op (``ops/attention.py``, kernel
``csrc/flash_attention.cu``), which has no backward; off (training,
``models/train.py``) it is the reference's einsum branch: logits in
``cfg.dtype`` masked with ``finfo(cfg.dtype).min``, a float32 softmax cast
back, then P.V. With a mesh of ``sp`` > 1 attached (``cfg.mesh``),
attention is the ring over ``sp`` instead (``parallel/ring_attention.py``),
as the reference routes it; the kernel serves only without a mesh.
``param_sharding_rules`` gives each parameter's layout on a (dp, tp, sp)
mesh, which ``models/train.py:make_sharded_train_step`` places.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nornicdb_tpu_torch.ops.attention import flash_attention
from nornicdb_tpu_torch.ops.similarity import l2_normalize
from nornicdb_tpu_torch.parallel.ring_attention import ring_attention

LN_EPS = 1e-6


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 6
    mlp_dim: int = 1536
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    # construction-time choice of attention: the B2 kernel (inference),
    # or the einsum the reference trains through (no kernel has a vjp)
    use_flash_attention: bool = True
    # the reference's activation sharding constraints; the sharded step's
    # member program holds those layouts whatever its value
    shard_activations: bool = False
    # a parallel.mesh.Mesh: with sp > 1, attention takes the ring
    mesh: Any = None

    @staticmethod
    def tiny() -> "EncoderConfig":
        return EncoderConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                             num_heads=4, mlp_dim=128, max_len=128)

    @staticmethod
    def mini() -> "EncoderConfig":
        """The committed-checkpoint shape, in float32."""
        return EncoderConfig(vocab_size=8192, hidden_size=160,
                             num_layers=2, num_heads=4, mlp_dim=640,
                             max_len=512, dtype=torch.float32)

    @staticmethod
    def bge_m3_like() -> "EncoderConfig":
        """XLM-R-large shape (bge-m3's backbone)."""
        return EncoderConfig(vocab_size=250_002, hidden_size=1024,
                             num_layers=24, num_heads=16, mlp_dim=4096,
                             max_len=8192)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A projection computed in ``dtype`` over float32 parameters, as
    flax's ``Dense(dtype=...)`` does."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, LN_EPS)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference encoder's einsum branch (differentiable): [B, S, H, Dh]
    in and out, mask [B, S] over keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        h = cfg.num_heads
        q = _dense(self.query, x, cfg.dtype).view(b, s, h, d // h)
        k = _dense(self.key, x, cfg.dtype).view(b, s, h, d // h)
        v = _dense(self.value, x, cfg.dtype).view(b, s, h, d // h)
        if cfg.mesh is not None and cfg.mesh.shape.get("sp", 1) > 1:
            # sequence parallel: exact ring attention over the sp axis
            out = ring_attention(q, k, v, mask, mesh=cfg.mesh, axis_name="sp",
                                 batch_axis="dp", head_axis="tp")
        elif cfg.use_flash_attention and cfg.mesh is None:
            out = flash_attention(q, k, v, mask)
        else:
            out = einsum_attention(q, k, v, mask, cfg.dtype)
        return _dense(self.out, out.reshape(b, s, d), cfg.dtype)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.attn = MultiHeadAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.mlp_up = nn.Linear(cfg.hidden_size, cfg.mlp_dim)
        self.mlp_down = nn.Linear(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attn(_layer_norm(self.ln1, x), mask)
        y = _dense(self.mlp_up, _layer_norm(self.ln2, x), dt)
        y = F.gelu(y, approximate="tanh")
        return x + _dense(self.mlp_down, y, dt)


class Encoder(nn.Module):
    """Token ids -> L2-normalized sentence embedding."""

    def __init__(self, cfg: EncoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = nn.Embedding(cfg.max_len, cfg.hidden_size)
        self.layers = nn.ModuleList(
            TransformerLayer(cfg) for _ in range(cfg.num_layers))
        self.ln_final = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fan-in-scaled normal weights (the scale of flax's defaults),
        zero biases, unit LayerNorm scales, drawn from ``generator``."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                fan_in = p.shape[1]
                p.normal_(0.0, fan_in ** -0.5, generator=generator)

    def forward(self, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = token_ids != 0
        pos = torch.arange(token_ids.shape[1], device=token_ids.device)
        x = (self.tok_embed(token_ids).to(cfg.dtype)
             + self.pos_embed(pos)[None].to(cfg.dtype))
        for layer in self.layers:
            x = layer(x, attention_mask)
        x = _layer_norm(self.ln_final, x)
        m = attention_mask[:, :, None].float()
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        return l2_normalize(pooled)


def param_sharding_rules(cfg: EncoderConfig) -> Callable[[str, Any], Tuple[Optional[str], ...]]:
    """Each parameter's spec on a (dp, tp, sp) mesh, by ``state_dict`` name,
    in the port's layouts: the reference's rules (heads and MLP width over
    ``tp``, embeddings over ``tp`` on the hidden axis, the rest replicated)
    through ``nn.Linear``'s ``[out, in]`` weights. The q/k/v biases are
    split by heads, as the reference's 2-D ``[h, hd]`` ones are; the other
    biases are 1-D there and replicated."""
    del cfg

    def rule(name: str, value) -> Tuple[Optional[str], ...]:
        if name in ("tok_embed.weight", "pos_embed.weight"):
            return (None, "tp")
        kind, leaf = name.split(".")[-2:]
        if kind in ("query", "key", "value"):
            return ("tp",) if leaf == "bias" else ("tp", None)  # [h*hd, d] by heads
        if kind == "out" and leaf == "weight":
            return (None, "tp")  # [d, h*hd]
        if kind == "mlp_up" and leaf == "weight":
            return ("tp", None)  # [mlp, d]
        if kind == "mlp_down" and leaf == "weight":
            return (None, "tp")  # [d, mlp]
        return (None,) * value.ndim

    return rule
