"""Training of the Heimdall decoder (counterpart of ``nornicdb_tpu/heimdall/train.py``).

Next-byte cross-entropy through the model's own ``forward_full``, Adam at
optax's defaults (``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-8), batch rows drawn
by ``np.random.default_rng(seed).integers`` as the reference draws them.
Checkpoints are the reference's flat ``.npz`` files: each package reads the
other's. The committed tiny checkpoint is read as data from its place in
the JAX package's tree.

CLI: ``python -m nornicdb_tpu_torch.heimdall.train <out.npz> [steps] [device]``
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.heimdall.model import (
    BOS,
    EOS,
    PAD,
    DecoderConfig,
    forward_full,
    init_params_numpy,
    leaves,
    params_to_device,
    params_to_numpy,
)


def sequence_logits(cfg: DecoderConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Logits for every position through ``forward_full``. tokens: [B, S]
    (PAD-padded) -> [B, S, V] float32."""
    logits, _caches = forward_full(cfg, params, tokens, tokens != PAD)
    return logits


def _loss_fn(cfg: DecoderConfig, params, batch: torch.Tensor) -> torch.Tensor:
    logits = sequence_logits(cfg, params, batch)  # [B, S, V]
    targets = torch.roll(batch, -1, dims=1)
    mask = (batch != PAD) & (targets != PAD)
    mask[:, -1] = False
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def encode_corpus(lines: Iterable[str], cfg: DecoderConfig) -> np.ndarray:
    """Each line becomes one PAD-padded row: BOS + bytes + EOS, the framing
    ``model.encode_bytes`` uses at generation time."""
    rows = []
    for line in lines:
        ids = [BOS] + list(line.encode("utf-8"))[: cfg.max_seq - 2] + [EOS]
        row = np.full(cfg.max_seq, PAD, np.int32)
        row[: len(ids)] = ids
        rows.append(row)
    return np.stack(rows)


def train(
    corpus: List[str],
    cfg: Optional[DecoderConfig] = None,
    steps: int = 300,
    lr: float = 3e-3,
    batch_size: int = 16,
    seed: int = 0,
    log_every: int = 0,
    device: DeviceLike = None,
    losses: Optional[List[float]] = None,
) -> Tuple[Dict[str, Any], float]:
    """Adam training loop from ``init_params(cfg, seed)``; returns (params
    as float32 tensors on ``device``, the last step's loss). ``losses``,
    when given, receives every step's loss."""
    dev = resolve_device(device)
    cfg = cfg or DecoderConfig.tiny()
    params = params_to_device(init_params_numpy(cfg, seed), dev)
    for p in leaves(params):
        p.requires_grad_(True)
    data = torch.from_numpy(encode_corpus(corpus, cfg).astype(np.int64)).to(dev)
    opt = torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    loss = float("nan")
    for i in range(steps):
        idx = rng.integers(0, len(data), min(batch_size, len(data)))
        batch = data[torch.from_numpy(idx).to(dev)]
        opt.zero_grad(set_to_none=True)
        loss_t = _loss_fn(cfg, params, batch)
        loss_t.backward()
        opt.step()
        loss = float(loss_t.detach())
        if losses is not None:
            losses.append(loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} loss {loss:.4f}")
    for p in leaves(params):
        p.requires_grad_(False)
    return params, loss


# -- checkpoint io --------------------------------------------------------


def save_params(path: str, cfg: DecoderConfig, params: Dict[str, Any]) -> None:
    """The reference's flat ``.npz``: ``cfg.*`` scalars, ``embed``, ``pos``,
    ``ln_f`` and ``layer{i}.{name}``, float32."""
    tree = params_to_numpy(params)
    flat = {
        "cfg.vocab": cfg.vocab,
        "cfg.d_model": cfg.d_model,
        "cfg.n_layers": cfg.n_layers,
        "cfg.n_heads": cfg.n_heads,
        "cfg.d_ff": cfg.d_ff,
        "cfg.max_seq": cfg.max_seq,
        "embed": tree["embed"],
        "pos": tree["pos"],
        "ln_f": tree["ln_f"],
    }
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            flat[f"layer{i}.{k}"] = v
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)


def load_params(path: str) -> Tuple[DecoderConfig, Dict[str, Any]]:
    """(cfg, the decoder tree as float32 numpy arrays); ``DecoderModel``
    and ``params_to_device`` put it on a device."""
    data = np.load(path, allow_pickle=False)
    cfg = DecoderConfig(
        vocab=int(data["cfg.vocab"]), d_model=int(data["cfg.d_model"]),
        n_layers=int(data["cfg.n_layers"]), n_heads=int(data["cfg.n_heads"]),
        d_ff=int(data["cfg.d_ff"]), max_seq=int(data["cfg.max_seq"]),
    )
    layers = []
    for i in range(cfg.n_layers):
        prefix = f"layer{i}."
        layers.append({
            k[len(prefix):]: np.asarray(data[k], np.float32)
            for k in data.files if k.startswith(prefix)
        })
    params = {
        "embed": np.asarray(data["embed"], np.float32),
        "pos": np.asarray(data["pos"], np.float32),
        "ln_f": np.asarray(data["ln_f"], np.float32),
        "layers": layers,
    }
    return cfg, params


def default_checkpoint_path() -> Optional[str]:
    """The committed tiny checkpoint, read as data from the JAX package's
    tree; None if absent."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "nornicdb_tpu", "heimdall", "checkpoints",
                        "heimdall_tiny.npz")
    return path if os.path.exists(path) else None


DEFAULT_CORPUS = [
    "nornicdb is a tpu-native graph database.",
    "heimdall watches the graph and answers questions.",
    "store memories, link them, and recall them later.",
    "vector search runs on the tpu matrix unit.",
    "the write-ahead log keeps every mutation durable.",
    "cypher queries match patterns over nodes and edges.",
    "embeddings are indexed for hybrid search.",
    "the decay manager ages episodic memories.",
]


def main() -> None:  # pragma: no cover
    """CLI: python -m nornicdb_tpu_torch.heimdall.train <out.npz> [steps] [device]"""
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "heimdall_tiny.npz"
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 600
    device = sys.argv[3] if len(sys.argv) > 3 else None
    cfg = DecoderConfig.tiny()
    params, loss = train(DEFAULT_CORPUS, cfg, steps=steps, log_every=50, device=device)
    save_params(out, cfg, params)
    print(f"saved {out} (final loss {loss:.4f})")


if __name__ == "__main__":  # pragma: no cover
    main()
