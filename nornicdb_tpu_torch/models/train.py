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

``make_sharded_train_step`` runs the same step over a (dp, tp, sp) mesh
(``parallel/mesh.py``), where the reference lets GSPMD partition it. Each
parameter is placed by ``encoder.param_sharding_rules``, one tensor a
distinct shard (``parallel/sharding.py``), and every member runs the
member program on its slice of the work: batch rows ``d``, positions
``s``, heads and MLP columns ``t``, in the reference's activation layouts,
with the collectives written out (``parallel/collectives.py``). Autograd
runs through the members' reads, so a replicated shard's gradient is the
sum over its readers, as GSPMD's all-reduce gives; AdamW steps the
distinct shards, each with its moments beside it. At ``MeshSpec(1, 1, 1)``
the step is ``contrastive_train_step`` bitwise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.models.encoder import (
    LN_EPS,
    Encoder,
    EncoderConfig,
    einsum_attention,
    param_sharding_rules,
)
from nornicdb_tpu_torch.ops.similarity import l2_normalize
from nornicdb_tpu_torch.parallel import collectives as coll
from nornicdb_tpu_torch.parallel.mesh import Mesh
from nornicdb_tpu_torch.parallel.ring_attention import _ring_attention_local
from nornicdb_tpu_torch.parallel.sharding import (
    NamedSharding,
    ShardedTensor,
    device_put,
    split,
)

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
    _refuse_kernel_path(model.cfg)
    loss = info_nce_loss(model(_ids(anchor_ids, dev)), model(_ids(positive_ids, dev)))
    loss.backward()
    return state.apply_gradients(), loss.detach()


def _ids(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x, np.int64)).to(dev)


def _refuse_kernel_path(cfg: EncoderConfig) -> None:
    if cfg.use_flash_attention:
        raise ValueError("train through the einsum attention "
                         "(EncoderConfig.use_flash_attention=False)")


# -- the sharded step ---------------------------------------------------------


@dataclass
class ShardedTrainState(TrainState):
    """A ``TrainState`` whose optimizer steps the distinct shards of
    ``params`` (``state_dict`` names to ``ShardedTensor``s) on ``mesh``;
    ``cfg`` carries the mesh."""

    params: Dict[str, ShardedTensor]
    mesh: Mesh
    cfg: EncoderConfig


def _param_shardings(params: Dict[str, torch.Tensor], cfg: EncoderConfig,
                     mesh: Mesh) -> Dict[str, NamedSharding]:
    rule = param_sharding_rules(cfg)
    return {name: NamedSharding(mesh, rule(name, p)) for name, p in params.items()}


def _opt_shardings(state: TrainState, param_sh: Dict[str, NamedSharding],
                   mesh: Mesh) -> Dict[str, Any]:
    """AdamW's state: the moments take their parameters' shardings, the
    step count is replicated."""
    del state
    return {"step": NamedSharding(mesh, ()), "exp_avg": param_sh, "exp_avg_sq": param_sh}


def _check_divides(what: str, n: int, axis: str, size: int) -> None:
    if n % size:
        raise ValueError(f"{what} {n} does not divide by {axis}={size}")


def make_sharded_train_step(model: Encoder, state: TrainState,
                            mesh: Mesh) -> Tuple[ShardedTrainState, Callable]:
    """Place ``model``'s parameters and ``state``'s AdamW moments on the
    (dp, tp, sp) ``mesh`` by the rules, and return (sharded_state, step);
    ``step(state, anchor_ids, positive_ids) -> (state, loss)`` shards the
    batch over dp and the sequence over sp. Raises ``ValueError`` when the
    heads, the hidden width or the MLP width do not divide by tp (the
    batch and sequence are checked a step)."""
    cfg = model.cfg
    _refuse_kernel_path(cfg)
    tp = mesh.shape["tp"]
    for what, n in (("num_heads", cfg.num_heads), ("hidden_size", cfg.hidden_size),
                    ("mlp_dim", cfg.mlp_dim)):
        _check_divides(what, n, "tp", tp)
    cfg = dataclasses.replace(cfg, mesh=mesh)
    named = dict(model.named_parameters())
    param_sh = _param_shardings(named, cfg, mesh)
    params = {name: device_put(p.detach(), param_sh[name]).requires_grad_()
              for name, p in named.items()}
    group = state.optimizer.param_groups[0]
    opt = torch.optim.AdamW([s for p in params.values() for s in p.shards.values()],
                            lr=group["lr"], betas=group["betas"], eps=group["eps"],
                            weight_decay=group["weight_decay"])
    opt_sh = _opt_shardings(state, param_sh, mesh)
    for name, p in named.items():
        st = state.optimizer.state.get(p)
        if not st:
            continue
        moments = {k: device_put(st[k], opt_sh[k][name]) for k in ("exp_avg", "exp_avg_sq")}
        for key, shard in params[name].shards.items():
            opt.state[shard] = {"step": st["step"].clone(),
                                **{k: m.shards[key] for k, m in moments.items()}}
    sharded = ShardedTrainState(step=state.step, optimizer=opt,
                                learning_rate=state.learning_rate, params=params,
                                mesh=mesh, cfg=cfg)

    def step(st: ShardedTrainState, anchor_ids, positive_ids):
        loss = sharded_contrastive_loss(st, anchor_ids, positive_ids)
        loss.backward()
        return st.apply_gradients(), loss.detach()

    return sharded, step


def sharded_contrastive_loss(state: ShardedTrainState, anchor_ids,
                             positive_ids) -> torch.Tensor:
    """The sharded step's loss, on the first member, with its graph: the
    member program encodes both batches, the embeddings are all-gathered
    over dp, and InfoNCE runs once over the whole batch."""
    mesh, cfg = state.mesh, state.cfg
    lead = mesh.members[0]
    a, p = _ids(anchor_ids, lead), _ids(positive_ids, lead)
    _check_divides("batch", a.shape[0], "dp", mesh.shape["dp"])
    _check_divides("sequence", a.shape[1], "sp", mesh.shape["sp"])
    blocks = {name: t.blocks() for name, t in state.params.items()}
    rows = NamedSharding(mesh, ("dp", "sp"))
    embs = [coll.all_gather(mesh, _encode_members(cfg, mesh, blocks, split(x, rows)),
                            "dp", axis=0)[0] for x in (a, p)]
    return info_nce_loss(*embs)


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, LN_EPS)


def _encode_members(cfg: EncoderConfig, mesh: Mesh, blocks: Dict[str, List[torch.Tensor]],
                    ids: List[torch.Tensor]) -> List[torch.Tensor]:
    """The member program (the reference's layouts): member (d, t, s) holds
    batch rows d and positions s of ``x`` [B/dp, S/sp, D] (whole over tp),
    heads and MLP columns t. Returns each member's L2-normalized
    embeddings [B/dp, D]."""
    dt, members = cfg.dtype, mesh.members
    n, tp = len(members), mesh.shape["tp"]
    heads, head_dim = cfg.num_heads // tp, cfg.hidden_size // cfg.num_heads
    tps = [coll.axis_index(mesh, "tp", m) for m in range(n)]
    b, s = ids[0].shape
    masks = [i != 0 for i in ids]

    def col(pre: str, xs, bias_cols: bool = False):
        """Column-parallel: this member's output columns (a replicated
        bias sliced to them when ``bias_cols``)."""
        w, bias = blocks[pre + ".weight"], blocks[pre + ".bias"]
        out = []
        for m, x in enumerate(xs):
            bm = bias[m]
            if bias_cols:
                width = bm.shape[0] // tp
                bm = bm[tps[m] * width:(tps[m] + 1) * width]
            out.append(F.linear(x.to(dt), w[m].to(dt), bm.to(dt)))
        return out

    def row(pre: str, xs):
        """Row-parallel: partial products summed over tp, the bias added
        once (by the member at t = 0)."""
        w, bias = blocks[pre + ".weight"], blocks[pre + ".bias"]
        parts = [F.linear(x.to(dt), w[m].to(dt), bias[m].to(dt) if tps[m] == 0 else None)
                 for m, x in enumerate(xs)]
        return coll.psum(mesh, parts, "tp")

    def norm(pre: str, xs):
        return [_layer_norm(x, blocks[pre + ".weight"][m], blocks[pre + ".bias"][m])
                for m, x in enumerate(xs)]

    tok = [F.embedding(ids[m], blocks["tok_embed.weight"][m]) for m in range(n)]
    pos = [F.embedding(torch.arange(coll.axis_index(mesh, "sp", m) * s,
                                    (coll.axis_index(mesh, "sp", m) + 1) * s,
                                    device=members[m]), blocks["pos_embed.weight"][m])
           for m in range(n)]
    tok = coll.all_gather(mesh, tok, "tp", axis=-1)
    pos = coll.all_gather(mesh, pos, "tp", axis=-1)
    x = [t.to(dt) + p[None].to(dt) for t, p in zip(tok, pos)]
    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        y = norm(pre + ".ln1", x)
        q, k, v = ([o.view(b, s, heads, head_dim) for o in col(f"{pre}.attn.{name}", y)]
                   for name in ("query", "key", "value"))
        if mesh.shape["sp"] > 1:
            att = _ring_attention_local(mesh, q, k, v, masks, "sp")
        else:
            att = [einsum_attention(*qkv, mask, dt) for *qkv, mask in zip(q, k, v, masks)]
        o = row(pre + ".attn.out", [a.reshape(b, s, heads * head_dim) for a in att])
        x = [xm + om for xm, om in zip(x, o)]
        y = col(pre + ".mlp_up", norm(pre + ".ln2", x), bias_cols=True)
        y = row(pre + ".mlp_down", [F.gelu(ym, approximate="tanh") for ym in y])
        x = [xm + ym for xm, ym in zip(x, y)]
    x = norm("ln_final", x)
    mf = [mask[:, :, None].float() for mask in masks]
    sums = coll.psum(mesh, [(xm * m).sum(dim=1) for xm, m in zip(x, mf)], "sp")
    counts = coll.psum(mesh, [m.sum(dim=1) for m in mf], "sp")
    return [l2_normalize(sm / c.clamp_min(1.0)) for sm, c in zip(sums, counts)]
