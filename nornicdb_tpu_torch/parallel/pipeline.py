"""Pipeline (pp) and expert (ep) parallelism over a mesh (counterpart of
``nornicdb_tpu/parallel/pipeline.py``).

The reference lays stages and experts out with ``shard_map``; here each
body runs for every member at once over per-member lists
(``parallel/collectives.py``):

- ``pipeline_apply``: a GPipe schedule of ``n_micro + pp - 1`` ticks.
  Stage 0 takes microbatch ``t`` (zeros past the end), every stage runs
  its block, the last stage emits microbatch ``t - (pp - 1)``, and
  ``ppermute`` moves each stage's output to the next. The outputs are
  ``psum``-ed over ``pp`` from the last stage (zeros elsewhere), as the
  reference broadcasts them.
- ``moe_apply``: GShard top-1 routing with a fixed capacity
  ``max(int(cf * b_local / E), 1)``, cumsum ranks, a token past the
  capacity dropped (it gives zeros), two untiled ``all_to_all`` exchanges
  over ``ep`` with owner-major expert ids, and the load-balancing loss
  ``pmean``-ed over ``ep``.
- ``make_pp_ep_train_step``: the pipeline, then the MoE head, a residual,
  MSE plus 0.01 times the aux loss, plain SGD.

Parameters draw from a ``torch.Generator``, not ``jax.random`` (ROADMAP
C35); ``place_pp_ep_params`` places given arrays (the reference's own,
say) by the reference's specs. Autograd runs through the member copies:
a stage's parameters read by each ``ep`` member get the sum of their
gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from nornicdb_tpu_torch.parallel import collectives as coll
from nornicdb_tpu_torch.parallel.mesh import Mesh, _device_array, devices as _devices
from nornicdb_tpu_torch.parallel.sharding import (
    NamedSharding,
    ShardedTensor,
    assemble,
    device_put,
    member_blocks,
)

Rng = Union[int, torch.Generator]


def _gen(rng: Rng) -> torch.Generator:
    return rng if isinstance(rng, torch.Generator) else torch.Generator().manual_seed(int(rng))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


# -- pipeline parallelism -------------------------------------------------


def init_pipeline_params(rng: Rng, n_stages: int, width: int,
                         scale: float = 0.02) -> Dict[str, torch.Tensor]:
    g = _gen(rng)
    return {
        "w1": torch.randn(n_stages, width, width, generator=g) * scale,
        "b1": torch.zeros(n_stages, width),
        "w2": torch.randn(n_stages, width, width, generator=g) * scale,
        "b2": torch.zeros(n_stages, width),
    }


def _stage_block(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One residual MLP stage; params are this stage's [1, ...] slices."""
    h = _gelu(x @ params["w1"][0] + params["b1"][0])
    return x + h @ params["w2"][0] + params["b2"][0]


def _member_params(params, mesh: Mesh, spec) -> list:
    """Each member's slice of a dict of parameters placed or split by
    ``spec``: a list of dicts."""
    per_name = {name: member_blocks(p, NamedSharding(mesh, spec[name]))
                for name, p in params.items()}
    return [{name: blocks[m] for name, blocks in per_name.items()}
            for m in range(len(mesh.members))]


def pipeline_apply(params, x: torch.Tensor, mesh: Mesh, n_microbatches: int,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """x [B, D] through the pp-staged network; B % n_microbatches == 0.
    ``batch_axis`` shards each microbatch's rows over a second mesh axis
    (the combined step passes ``"ep"``); they must divide evenly. Returns
    [B, D] on ``x``'s device."""
    pp = mesh.shape["pp"]
    batch, width = x.shape
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} does not divide into {n_microbatches} microbatches")
    micro = batch // n_microbatches
    if batch_axis is not None and micro % mesh.shape[batch_axis]:
        raise ValueError(f"microbatch rows {micro} not divisible by "
                         f"{batch_axis}={mesh.shape[batch_axis]}")
    n_ticks = n_microbatches + pp - 1
    data = NamedSharding(mesh, (None, batch_axis))
    xs = member_blocks(x.reshape(n_microbatches, micro, width), data)
    local = _member_params(params, mesh, {name: ("pp",) for name in params})
    stage = [coll.axis_index(mesh, "pp", m) for m in range(len(xs))]
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    held = [torch.zeros_like(xm[0]) for xm in xs]
    outputs = [[None] * n_microbatches for _ in xs]
    for t in range(n_ticks):
        out = []
        for m, xm in enumerate(xs):
            if stage[m] == 0:
                held[m] = xm[t] if t < n_microbatches else torch.zeros_like(xm[0])
            out.append(_stage_block(local[m], held[m]))
            if stage[m] == pp - 1 and t >= pp - 1:
                outputs[m][t - (pp - 1)] = out[m]
        held = coll.ppermute(mesh, out, "pp", perm)
    # only the last stage holds real outputs; psum broadcasts them
    stacked = [torch.stack(o) if stage[m] == pp - 1 else torch.zeros_like(xs[m])
               for m, o in enumerate(outputs)]
    res = coll.psum(mesh, stacked, "pp")
    return assemble(res, data, x.device).reshape(batch, width)


# -- expert parallelism (MoE) ---------------------------------------------


def init_moe_params(rng: Rng, n_experts: int, width: int, hidden: int,
                    scale: float = 0.02) -> Dict[str, torch.Tensor]:
    g = _gen(rng)
    return {
        "router": torch.randn(width, n_experts, generator=g) * scale,
        "wi": torch.randn(n_experts, width, hidden, generator=g) * scale,
        "wo": torch.randn(n_experts, hidden, width, generator=g) * scale,
    }


MOE_SPECS = {"router": (), "wi": ("ep",), "wo": ("ep",)}


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(params, x: torch.Tensor, mesh: Mesh,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE layer: x [B, D] -> (y [B, D], aux_loss), both on ``x``'s
    device. B is sharded over ``ep``; expert ``e`` lives on the member at
    ``ep`` coordinate ``e // (E / ep)``; the router is replicated."""
    ep = mesh.shape["ep"]
    n_experts = params["wi"].shape[0]
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not divide over ep={ep}")
    n_local = n_experts // ep
    rows = NamedSharding(mesh, ("ep",))
    xs = member_blocks(x, rows)
    local = _member_params(params, mesh, MOE_SPECS)
    b_local, width = xs[0].shape
    capacity = max(int(capacity_factor * b_local / n_experts), 1)

    slots, kept, auxes = [], [], []
    for xm, pm in zip(xs, local):
        scores = torch.softmax(xm @ pm["router"], dim=-1)  # [b, E]
        gate, expert = scores.max(dim=-1)
        onehot = _one_hot(expert, n_experts, xm.dtype)
        # position of each token within its expert's queue
        pos = torch.cumsum(onehot, dim=0) * onehot
        rank = (pos.sum(dim=-1) - 1.0).to(torch.int32)
        keep = rank < capacity  # overflow tokens are dropped
        dispatch = onehot[:, :, None] * _one_hot(rank, capacity, xm.dtype)[:, None, :]
        dispatch = dispatch * keep[:, None, None].to(xm.dtype)
        # load-balancing aux loss (GShard eq. 4)
        density, proxy = onehot.mean(dim=0), scores.mean(dim=0)
        auxes.append((density * proxy).sum() * (n_experts ** 2) / 100.0)
        s = torch.einsum("bec,bd->ecd", dispatch, xm)
        slots.append(s.reshape(ep, n_local, capacity, width))
        kept.append((dispatch, gate))
    # split the owner axis; received chunks stack on a source axis at 2
    slots = coll.all_to_all(mesh, slots, "ep", split_axis=0, concat_axis=2)
    ys = []
    for s, pm in zip(slots, local):
        s = s.movedim(2, 1).reshape(n_local, ep * capacity, width)
        h = _gelu(torch.einsum("ecd,edh->ech", s, pm["wi"]))
        ys.append(torch.einsum("ech,ehd->ecd", h, pm["wo"]).reshape(n_local, ep, capacity, width))
    # the inverse exchange: split the source axis, stack owners at 0
    ys = coll.all_to_all(mesh, ys, "ep", split_axis=1, concat_axis=0)
    outs = [torch.einsum("bec,ecd->bd", dispatch, y.reshape(n_experts, capacity, width))
            * gate[:, None] for y, (dispatch, gate) in zip(ys, kept)]
    aux = coll.pmean(mesh, auxes, "ep")
    return assemble(outs, rows, x.device), aux[0].to(x.device)


# -- combined pp x ep training step ---------------------------------------


def pp_ep_shardings(mesh: Mesh) -> Dict[str, Dict[str, NamedSharding]]:
    """The reference's placement: ``pipe.*`` over ``pp``, ``wi``/``wo`` over
    ``ep``, ``router`` replicated."""
    return {"pipe": {k: NamedSharding(mesh, ("pp",)) for k in ("w1", "b1", "w2", "b2")},
            "moe": {k: NamedSharding(mesh, s) for k, s in MOE_SPECS.items()}}


def place_pp_ep_params(mesh: Mesh, params) -> Tuple[Dict[str, Dict[str, ShardedTensor]], dict]:
    """``params`` ({"pipe": {...}, "moe": {...}} of host arrays or tensors,
    the reference's own included) placed by ``pp_ep_shardings``, each shard
    a leaf that trains. Returns (params, shardings)."""
    shardings = pp_ep_shardings(mesh)
    placed = {part: {k: device_put(v, shardings[part][k]).requires_grad_()
                     for k, v in params[part].items()}
              for part in ("pipe", "moe")}
    return placed, shardings


def make_pp_ep_train_step(mesh: Mesh, width: int, hidden: int, n_microbatches: int,
                          learning_rate: float = 1e-3) -> Tuple[Callable, Callable]:
    """(init_params, step) for a pipeline of MLP stages followed by an
    expert-parallel MoE head over a (pp, ep) mesh.
    ``init_params(rng) -> (params, shardings)``;
    ``step(params, x, y) -> (params, loss)`` updates the shards in place."""
    pp, ep = mesh.shape["pp"], mesh.shape["ep"]

    def init_params(rng: Rng):
        g = _gen(rng)
        return place_pp_ep_params(mesh, {"pipe": init_pipeline_params(g, pp, width),
                                         "moe": init_moe_params(g, ep, width, hidden)})

    def loss_fn(params, x, y):
        h = pipeline_apply(params["pipe"], x, mesh, n_microbatches, batch_axis="ep")
        delta, aux = moe_apply(params["moe"], h, mesh)
        out = h + delta  # residual MoE head
        return ((out - y) ** 2).mean() + 0.01 * aux

    def step(params, x, y):
        loss = loss_fn(params, x, y)
        loss.backward()
        with torch.no_grad():
            for part in params.values():
                for p in part.values():
                    for s in p.shards.values():
                        s -= learning_rate * s.grad
                        s.grad = None
        return params, loss.detach()

    return init_params, step


def make_pp_ep_mesh(n_devices: int, devices=None) -> Mesh:
    """Split devices into (pp, ep): pp gets 2 when possible, ep the rest."""
    pp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    ep = n_devices // pp
    devs = list(devices if devices is not None else _devices())[:n_devices]
    return Mesh(_device_array(devs, (pp, ep)), ("pp", "ep"))
