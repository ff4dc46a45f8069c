"""Carry flax encoder parameters across to the port's ``Encoder``, and back.

``params_from_jax`` takes the flax parameter tree as nested dicts of
numpy arrays and returns a ``state_dict``; ``params_to_jax`` is its
inverse (the tree ``models/pretrain.save_checkpoint`` writes):

- ``DenseGeneral`` q/k/v kernel ``[d, h, hd]`` -> Linear weight ``[h*hd, d]``,
  bias ``[h, hd]`` -> ``[h*hd]``;
- the attention ``out`` kernel ``[h, hd, d]`` -> Linear weight ``[d, h*hd]``;
- a ``Dense`` kernel ``[in, out]`` is transposed;
- ``LayerNorm`` ``scale`` -> ``weight``; ``Embed`` ``embedding`` -> ``weight``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _qkv(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"], np.float32)  # [d, h, hd]
    d = kernel.shape[0]
    return {"weight": _f32(kernel.reshape(d, -1).T),
            "bias": _f32(np.asarray(p["bias"]).reshape(-1))}


def _out(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"], np.float32)  # [h, hd, d]
    d = kernel.shape[-1]
    return {"weight": _f32(kernel.reshape(-1, d).T),
            "bias": _f32(p["bias"])}


def _dense(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _f32(np.asarray(p["kernel"]).T), "bias": _f32(p["bias"])}


def _norm(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _f32(p["scale"]), "bias": _f32(p["bias"])}


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``Encoder`` params (nested dicts of arrays) -> ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, parts: Dict[str, torch.Tensor]) -> None:
        for k, v in parts.items():
            sd[f"{prefix}.{k}"] = v

    sd["tok_embed.weight"] = _f32(tree["tok_embed"]["embedding"])
    sd["pos_embed.weight"] = _f32(tree["pos_embed"]["embedding"])
    put("ln_final", _norm(tree["ln_final"]))
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    for i in range(n_layers):
        lp = tree[f"layer_{i}"]
        pre = f"layers.{i}"
        put(f"{pre}.ln1", _norm(lp["ln1"]))
        put(f"{pre}.ln2", _norm(lp["ln2"]))
        for name in ("query", "key", "value"):
            put(f"{pre}.attn.{name}", _qkv(lp["attn"][name]))
        put(f"{pre}.attn.out", _out(lp["attn"]["out"]))
        put(f"{pre}.mlp_up", _dense(lp["mlp_up"]))
        put(f"{pre}.mlp_down", _dense(lp["mlp_down"]))
    return sd



def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_jax(sd: Mapping[str, torch.Tensor], num_heads: int) -> Dict[str, Any]:
    """``Encoder.state_dict()`` -> the flax ``Encoder`` tree (nested dicts
    of float32 numpy arrays, the head axes split as flax keeps them)."""
    def norm(pre: str) -> Dict[str, np.ndarray]:
        return {"scale": _np(sd[pre + ".weight"]), "bias": _np(sd[pre + ".bias"])}

    def dense(pre: str) -> Dict[str, np.ndarray]:
        return {"kernel": np.ascontiguousarray(_np(sd[pre + ".weight"]).T),
                "bias": _np(sd[pre + ".bias"])}

    tree: Dict[str, Any] = {
        "tok_embed": {"embedding": _np(sd["tok_embed.weight"])},
        "pos_embed": {"embedding": _np(sd["pos_embed.weight"])},
        "ln_final": norm("ln_final"),
    }
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    for i in range(n_layers):
        pre = f"layers.{i}"
        attn: Dict[str, Any] = {}
        for name in ("query", "key", "value"):
            p = dense(f"{pre}.attn.{name}")  # kernel [d, h*hd]
            attn[name] = {"kernel": p["kernel"].reshape(p["kernel"].shape[0], num_heads, -1),
                          "bias": p["bias"].reshape(num_heads, -1)}
        p = dense(f"{pre}.attn.out")  # kernel [h*hd, d]
        attn["out"] = {"kernel": p["kernel"].reshape(num_heads, -1, p["kernel"].shape[-1]),
                       "bias": p["bias"]}
        tree[f"layer_{i}"] = {
            "ln1": norm(f"{pre}.ln1"), "ln2": norm(f"{pre}.ln2"), "attn": attn,
            "mlp_up": dense(f"{pre}.mlp_up"), "mlp_down": dense(f"{pre}.mlp_down"),
        }
    return tree
