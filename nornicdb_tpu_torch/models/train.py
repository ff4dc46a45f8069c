"""Contrastive training of the encoder, on one device (counterpart of the
unsharded half of ``nornicdb_tpu/models/train.py``).

The step is the reference's symmetric InfoNCE with in-batch negatives:
row i's positive is column i, in both directions. The optimizer is AdamW
at optax's ``adamw`` defaults (``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-8,
weight decay 1e-4 on every parameter; torch's own default decay is 0.01),
with a learning rate that may be a function of the step, read before each
update as optax's schedules are. The encoder trains through its einsum
attention (``use_flash_attention=False``): the B2 kernel has no backward,
as the reference's Pallas kernel has no vjp. Initial weights come from a
``torch.Generator``, not ``jax.random`` (ROADMAP C32); a caller that needs
the reference's draws passes its parameters (``models/weights.py``).
The sharded step (``make_sharded_train_step``) belongs to the
multi-device slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.models.encoder import Encoder, EncoderConfig

LearningRate = Union[float, Callable[[int], float]]
WEIGHT_DECAY = 1e-4  # optax.adamw's default


@dataclass
class TrainState:
    step: int
    optimizer: torch.optim.Optimizer
    learning_rate: LearningRate

    def apply_gradients(self) -> "TrainState":
        """One AdamW update from the gradients the parameters hold, at the
        rate of the current step, then the gradients are cleared."""
        lr = self.learning_rate
        rate = float(lr(self.step)) if callable(lr) else float(lr)
        for group in self.optimizer.param_groups:
            group["lr"] = rate
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def create_train_state(
    cfg: EncoderConfig,
    rng: Union[int, torch.Generator] = 0,
    learning_rate: LearningRate = 1e-4,
    seq_len: int = 64,
    device: DeviceLike = None,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Encoder, TrainState]:
    """(model, state): an ``Encoder`` on ``device`` that trains through its
    einsum attention, initialised from ``rng`` (a seed or a generator) or
    loaded from ``params`` (a ``state_dict``), and its AdamW state.
    ``seq_len`` is the reference's init shape; the port needs none."""
    del seq_len
    dev = resolve_device(device)
    gen = rng if isinstance(rng, torch.Generator) else torch.Generator().manual_seed(int(rng))
    model = Encoder(dataclasses.replace(cfg, use_flash_attention=False), generator=gen)
    if params is not None:
        model.load_state_dict(params)
    model.to(dev).train()
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WEIGHT_DECAY)
    return model, TrainState(step=0, optimizer=opt, learning_rate=learning_rate)


def info_nce_loss(anchors: torch.Tensor, positives: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch negatives: anchor->positive and positive->anchor."""
    logits = anchors @ positives.T / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def contrastive_train_step(
    model: Encoder,
    state: TrainState,
    anchor_ids,
    positive_ids,
) -> Tuple[TrainState, torch.Tensor]:
    """One step on one device; returns (state, the step's loss, detached)."""
    dev = next(model.parameters()).device

    def ids(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.int64)
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    if model.cfg.use_flash_attention:
        raise ValueError("train through the einsum attention "
                         "(EncoderConfig.use_flash_attention=False)")
    loss = info_nce_loss(model(ids(anchor_ids)), model(ids(positive_ids)))
    loss.backward()
    return state.apply_gradients(), loss.detach()
