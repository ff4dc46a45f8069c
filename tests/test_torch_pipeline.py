"""The port's pipeline and expert parallelism
(``nornicdb_tpu_torch/parallel/pipeline.py``) and the collectives its
bodies call (``parallel/collectives.py``) against the JAX package's
(``tests/test_pipeline_moe.py``), on the JAX package's own parameters
carried across: the JAX package over ``tests/conftest.py``'s eight CPU
devices, the port over eight CPU members.

Tolerances: float32 outputs, aux losses and gradients within rtol/atol
1e-5 (sums in another order); the collectives bitwise (they move and add
the same numbers in the same order); five SGD steps' losses within rtol
1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nornicdb_tpu.parallel import pipeline as jpipe
from nornicdb_tpu.parallel.mesh import compat_shard_map
from nornicdb_tpu_torch.parallel import collectives as coll
from nornicdb_tpu_torch.parallel import mesh as tmesh
from nornicdb_tpu_torch.parallel import pipeline as tpipe
from nornicdb_tpu_torch.parallel.sharding import ShardedTensor

torch.set_num_threads(1)

TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes():
    with tmesh.member_devices([CPU] * 8):
        tm = tpipe.make_pp_ep_mesh(8)
    return tm, jpipe.make_pp_ep_mesh(8, jax.devices())


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# -- the collectives ----------------------------------------------------------

_BLOCK = (4, 2, 3)
_COLLECTIVES = {
    "psum_ep": (lambda x: jax.lax.psum(x, "ep"), lambda m, xs: coll.psum(m, xs, "ep")),
    "psum_pp": (lambda x: jax.lax.psum(x, "pp"), lambda m, xs: coll.psum(m, xs, "pp")),
    "pmean_ep": (lambda x: jax.lax.pmean(x, "ep"), lambda m, xs: coll.pmean(m, xs, "ep")),
    "all_gather_ep": (lambda x: jax.lax.all_gather(x, "ep", axis=1, tiled=True),
                      lambda m, xs: coll.all_gather(m, xs, "ep", axis=1)),
    "all_gather_pp": (lambda x: jax.lax.all_gather(x, "pp", axis=0, tiled=True),
                      lambda m, xs: coll.all_gather(m, xs, "pp", axis=0)),
    "all_to_all_ep": (lambda x: jax.lax.all_to_all(x, "ep", 0, 2, tiled=False),
                      lambda m, xs: coll.all_to_all(m, xs, "ep", 0, 2)),
    "all_to_all_pp": (lambda x: jax.lax.all_to_all(x, "pp", 1, 0, tiled=False),
                      lambda m, xs: coll.all_to_all(m, xs, "pp", 1, 0)),
    "ppermute_ring": (lambda x: jax.lax.ppermute(x, "ep", [(i, (i + 1) % 4) for i in range(4)]),
                      lambda m, xs: coll.ppermute(m, xs, "ep", [(i, (i + 1) % 4) for i in range(4)])),
    "ppermute_partial": (lambda x: jax.lax.ppermute(x, "pp", [(0, 1)]),
                         lambda m, xs: coll.ppermute(m, xs, "pp", [(0, 1)])),
    "axis_index": (lambda x: x * 0 + 10 * jax.lax.axis_index("pp") + jax.lax.axis_index("ep"),
                   lambda m, xs: [x * 0 + 10 * coll.axis_index(m, "pp", i) + coll.axis_index(m, "ep", i)
                                  for i, x in enumerate(xs)]),
}


@pytest.mark.parametrize("name", sorted(_COLLECTIVES))
def test_collectives_match_jax(meshes, name):
    tm, jm = meshes
    jfn, tfn = _COLLECTIVES[name]
    x = np.random.default_rng(1).standard_normal((2, 4) + _BLOCK).astype(np.float32)
    body = compat_shard_map(lambda b: jfn(b[0, 0])[None, None], mesh=jm,
                            in_specs=P("pp", "ep"), out_specs=P("pp", "ep"))
    want = np.asarray(jax.jit(body)(x))
    got = tfn(tm, [torch.from_numpy(x[p, e]) for p in range(2) for e in range(4)])
    for m, g in enumerate(got):
        assert np.array_equal(g.numpy(), want[m // 4, m % 4]), m


def test_collectives_carry_gradients_to_every_member(meshes):
    tm, _ = meshes
    xs = [torch.full((4, 2), float(m), requires_grad=True) for m in range(8)]
    out = coll.all_to_all(tm, coll.psum(tm, xs, "pp"), "ep", 0, 1)
    sum(o.sum() * (i + 1) for i, o in enumerate(out)).backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in xs)


# -- pipeline parallelism -----------------------------------------------------


def _sequential(params, x, pp):
    for s in range(pp):
        x = tpipe._stage_block({k: v[s:s + 1] for k, v in params.items()}, x)
    return x


@pytest.mark.parametrize("n_micro,batch_axis", [(2, None), (4, None), (8, None), (2, "ep"),
                                                (4, "ep")])
def test_pipeline_matches_jax(meshes, n_micro, batch_axis):
    tm, jm = meshes
    params = _np(jpipe.init_pipeline_params(jax.random.PRNGKey(0), 2, 16))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (16, 16)))
    want = jax.jit(functools.partial(jpipe.pipeline_apply, mesh=jm, n_microbatches=n_micro,
                                     batch_axis=batch_axis))(params, x)
    got = tpipe.pipeline_apply(_t(params), torch.from_numpy(x), tm, n_micro,
                               batch_axis=batch_axis)
    _close(got, want)
    _close(got, _sequential(_t(params), torch.from_numpy(x), 2))


def test_pipeline_gradients_reach_every_stage_as_in_jax(meshes):
    tm, jm = meshes
    params = _np(jpipe.init_pipeline_params(jax.random.PRNGKey(4), 2, 8))
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (4, 8)))
    want = jax.jit(jax.grad(lambda p: jnp.sum(jpipe.pipeline_apply(p, x, jm, 2) ** 2)))(params)
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    (tpipe.pipeline_apply(tp, torch.from_numpy(x), tm, 2) ** 2).sum().backward()
    for name, g in tp.items():
        _close(g.grad, want[name])
        assert (g.grad.reshape(2, -1).norm(dim=1) > 0).all(), name


def test_pipeline_refuses_rows_that_do_not_divide(meshes):
    tm, _ = meshes
    params = tpipe.init_pipeline_params(0, 2, 8)
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply(params, torch.zeros(6, 8), tm, 4)
    with pytest.raises(ValueError, match="ep=4"):
        tpipe.pipeline_apply(params, torch.zeros(8, 8), tm, 4, batch_axis="ep")


# -- expert parallelism -------------------------------------------------------


def _moe_params(seed, width=16, hidden=32, steer=False):
    params = _np(jpipe.init_moe_params(jax.random.PRNGKey(seed), 4, width, hidden))
    if steer:  # every token to expert 0: a small capacity drops tokens
        params["router"][:, 0] = 10.0
    return params


@pytest.mark.parametrize("cf,steer", [(8.0, False), (1.25, False), (0.5, True), (1.25, True)])
def test_moe_matches_jax(meshes, cf, steer):
    tm, jm = meshes
    params = _moe_params(6 if steer else 2, steer=steer)
    x = np.array(jax.random.normal(jax.random.PRNGKey(7), (16, 16)))
    y, aux = jax.jit(functools.partial(jpipe.moe_apply, mesh=jm, capacity_factor=cf))(params, x)
    ty, taux = tpipe.moe_apply(_t(params), torch.from_numpy(x), tm, capacity_factor=cf)
    _close(ty, y)
    _close(taux, aux)
    dropped = np.all(np.asarray(y) == 0.0, axis=1)
    assert np.array_equal((ty == 0).all(dim=1).numpy(), dropped)
    if steer:
        assert dropped.any()


def test_moe_matches_a_dense_per_token_expert_when_nothing_drops(meshes):
    tm, _ = meshes
    params = _t(_moe_params(2))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 16))))
    y, aux = tpipe.moe_apply(params, x, tm, capacity_factor=8.0)
    scores = torch.softmax(x @ params["router"], -1)
    gate, e = scores.max(-1)
    ref = torch.stack([tpipe._gelu(x[i] @ params["wi"][e[i]]) @ params["wo"][e[i]] * gate[i]
                       for i in range(8)])
    _close(y, ref.detach(), 1e-5)
    assert float(aux) > 0


def test_moe_gradients_match_jax(meshes):
    tm, jm = meshes
    params = _moe_params(8, width=8, hidden=16)
    x = np.array(jax.random.normal(jax.random.PRNGKey(9), (16, 8)))

    def loss(p):
        out, aux = jpipe.moe_apply(p, x, jm, capacity_factor=8.0)
        return jnp.sum(out ** 2) + aux

    want = jax.jit(jax.grad(loss))(params)
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    out, aux = tpipe.moe_apply(tp, torch.from_numpy(x), tm, capacity_factor=8.0)
    ((out ** 2).sum() + aux).backward()
    for name, g in tp.items():
        _close(g.grad, want[name])
    assert float(tp["router"].grad.norm()) > 0 and float(tp["wi"].grad.norm()) > 0


def test_moe_gradients_reach_the_placed_expert_shards(meshes):
    tm, _ = meshes
    placed, _ = tpipe.place_pp_ep_params(tm, {"pipe": tpipe.init_pipeline_params(1, 2, 8),
                                              "moe": tpipe.init_moe_params(1, 4, 8, 16)})
    x = torch.randn(32, 8, generator=torch.Generator().manual_seed(2))
    out, aux = tpipe.moe_apply(placed["moe"], x, tm, capacity_factor=8.0)
    ((out ** 2).sum() + aux).backward()
    wi = placed["moe"]["wi"]
    assert sorted(wi.shards) == [(e, 0, 0) for e in range(4)]
    assert all(float(s.grad.norm()) > 0 for s in wi.shards.values())
    assert float(placed["moe"]["router"].shards[(0, 0)].grad.norm()) > 0


# -- the combined step --------------------------------------------------------


def test_place_pp_ep_params_lays_out_stages_and_experts(meshes):
    tm, _ = meshes
    placed, shardings = tpipe.place_pp_ep_params(
        tm, {"pipe": tpipe.init_pipeline_params(0, 2, 8), "moe": tpipe.init_moe_params(0, 4, 8, 16)})
    assert "pp" in str(shardings["pipe"]["w1"]) and "ep" in str(shardings["moe"]["wi"])
    w1, wi, router = placed["pipe"]["w1"], placed["moe"]["wi"], placed["moe"]["router"]
    assert isinstance(w1, ShardedTensor) and w1.shape == (2, 8, 8)
    assert {s.data.shape for s in w1.addressable_shards} == {(1, 8, 8)}
    assert {s.data.shape for s in wi.addressable_shards} == {(1, 8, 16)}
    assert router.sharding.is_fully_replicated and len(router.shards) == 1
    # stage p lives on the first member of pp row p, expert e on member e
    assert w1.owners == {(0, 0, 0): 0, (1, 0, 0): 4}
    assert wi.owners == {(e, 0, 0): e for e in range(4)}


def test_pp_ep_train_step_matches_jax(meshes):
    tm, jm = meshes
    init_fn, step = jpipe.make_pp_ep_train_step(jm, width=16, hidden=32, n_microbatches=2,
                                                learning_rate=0.2)
    jparams, _ = init_fn(jax.random.PRNGKey(3))
    _, tstep = tpipe.make_pp_ep_train_step(tm, width=16, hidden=32, n_microbatches=2,
                                           learning_rate=0.2)
    tparams, _ = tpipe.place_pp_ep_params(tm, _np(jparams))
    x = np.array(jax.random.normal(jax.random.PRNGKey(4), (16, 16)))
    for _ in range(5):
        jparams, jl = step(jparams, x, x * 0.5)
        tparams, tl = tstep(tparams, torch.from_numpy(x), torch.from_numpy(x * 0.5))
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))


def test_pp_ep_train_step_learns_from_its_own_init(meshes):
    tm, _ = meshes
    init_fn, step = tpipe.make_pp_ep_train_step(tm, width=16, hidden=32, n_microbatches=2,
                                                learning_rate=0.2)
    params, _ = init_fn(3)
    again, _ = init_fn(torch.Generator().manual_seed(3))
    assert torch.equal(params["moe"]["wo"].gather(), again["moe"]["wo"].gather())
    x = torch.randn(16, 16, generator=torch.Generator().manual_seed(4))
    losses = []
    for _ in range(40):
        params, loss = step(params, x, x * 0.5)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.95


@pytest.mark.parametrize("n", range(1, 9))
def test_make_pp_ep_mesh_matches_jax(n):
    jm = jpipe.make_pp_ep_mesh(n, jax.devices())
    tm = tpipe.make_pp_ep_mesh(n, [CPU] * 8)
    assert tm.axis_names == tuple(jm.axis_names) == ("pp", "ep")
    assert tm.shape == dict(jm.shape)
    with tmesh.member_devices([CPU] * n):
        assert tpipe.make_pp_ep_mesh(n).shape == dict(jm.shape)
