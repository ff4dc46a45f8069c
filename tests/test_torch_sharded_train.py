"""The port's sharded encoder train step (``nornicdb_tpu_torch/models/train.py``:
``make_sharded_train_step``, the member program, ``param_sharding_rules``)
against the JAX package's (``tests/test_models.py::TestShardedTraining``),
in float32 on a (dp 2, tp 2, sp 2) mesh: the JAX package over
``tests/conftest.py``'s eight CPU devices, the port over eight CPU members,
both from the JAX package's initial weights (``models/weights.py``).

Tolerances (``tests/test_torch_train.py``'s for one device): the first
step's loss within 1e-5 and every weight within 1e-5 but each layer's key
bias; three steps' losses and weights within 1e-4. The key bias's
gradient is zero in exact arithmetic, so each side holds rounding noise
there, which Adam scales to about the rate: within 2.1x the rate a step.
Gradients within 1e-5 of the single-device step's. ``MeshSpec(1, 1, 1)``
is the single-device step bitwise, and the shards are the JAX package's
shards bitwise (the same numbers, moved)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.models import encoder as jenc
from nornicdb_tpu.models import train as jtr
from nornicdb_tpu.parallel.mesh import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from nornicdb_tpu_torch.models import encoder as tenc
from nornicdb_tpu_torch.models import train as ttr
from nornicdb_tpu_torch.models.weights import params_from_jax
from nornicdb_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

LR = 1e-3
CPU = torch.device("cpu")
SPEC = (2, 2, 2)


def _cfgs(**kw):
    shape = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
                 max_len=64)
    shape.update(kw)
    return (jenc.EncoderConfig(**shape, shard_activations=True, dtype=jnp.float32),
            tenc.EncoderConfig(**shape, shard_activations=True, dtype=torch.float32))


def _batch(seed=1, b=4, s=32):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 500, (b, s)).astype(np.int32)
    p = rng.integers(1, 500, (b, s)).astype(np.int32)
    a[:, 26:] = 0  # padding: masked keys and pooling counts differ by member
    p[1, 9:] = 0
    return a, p


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _mesh(spec=SPEC):
    return tmesh.make_mesh(tmesh.MeshSpec(*spec), [CPU] * int(np.prod(spec)))


def _sharded(params, spec=SPEC, cfg=None):
    cfg = cfg or _cfgs()[1]
    model, state = ttr.create_train_state(cfg, 0, learning_rate=LR, device="cpu",
                                          params=params)
    return ttr.make_sharded_train_step(model, state, _mesh(spec))


def _state_close(want, got, atol, key_bias_atol):
    for k, w in want.items():
        tol = key_bias_atol if k.endswith("attn.key.bias") else atol
        assert (w - got[k]).abs().max() <= tol, k


def _weights(state):
    return {name: t.gather("cpu") for name, t in state.params.items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's sharded step, 3 times from its initial weights."""
    cj, _ = _cfgs()
    model, state = jtr.create_train_state(cj, jax.random.PRNGKey(2), learning_rate=LR)
    init = params_from_jax(_np(state.params))
    sharded, step = jtr.make_sharded_train_step(model, state, jmake_mesh(JMeshSpec(*SPEC)))
    a, p = _batch()
    losses, states = [], []
    for _ in range(3):
        sharded, loss = step(sharded, jnp.asarray(a), jnp.asarray(p))
        losses.append(float(loss))
        states.append(params_from_jax(_np(sharded.params)))
    return init, losses, states


@pytest.mark.parametrize("steps", [1, 3])
def test_sharded_step_matches_jax_and_the_single_device_step(jax_run, steps):
    init, jax_losses, jax_states = jax_run
    _, ct = _cfgs()
    a, p = _batch()
    state, step = _sharded(init)
    model, single = ttr.create_train_state(ct, 0, learning_rate=LR, device="cpu", params=init)
    for i in range(steps):
        state, loss = step(state, a, p)
        single, ref = ttr.contrastive_train_step(model, single, a, p)
        tol = 1e-5 if i == 0 else 1e-4
        assert abs(float(loss) - jax_losses[i]) <= tol
        assert abs(float(loss) - float(ref)) <= tol
    assert state.step == steps == single.step
    tol = 1e-5 if steps == 1 else 1e-4
    got = _weights(state)
    _state_close(jax_states[steps - 1], got, tol, 2.1 * LR * steps)
    _state_close({k: v.detach() for k, v in model.state_dict().items()}, got, tol,
                 2.1 * LR * steps)


@pytest.mark.parametrize("spec", [SPEC, (1, 2, 4), (4, 2, 1), (1, 4, 2)])
def test_gradients_match_the_single_device_step(jax_run, spec):
    init = jax_run[0]
    a, p = _batch()
    state, _ = _sharded(init, spec)
    ttr.sharded_contrastive_loss(state, a, p).backward()
    model, _ = ttr.create_train_state(_cfgs()[1], 0, device="cpu", params=init)
    ttr.info_nce_loss(model(torch.from_numpy(a).long()), model(torch.from_numpy(p).long())).backward()
    for name, q in model.named_parameters():
        assert (state.params[name].gather(grad=True) - q.grad).abs().max() <= 1e-5, name


def test_a_mesh_of_one_is_the_single_device_step_bitwise(jax_run):
    init = jax_run[0]
    a, p = _batch()
    state, step = _sharded(init, (1, 1, 1))
    model, single = ttr.create_train_state(_cfgs()[1], 0, learning_rate=LR, device="cpu",
                                           params=init)
    for _ in range(3):
        state, loss = step(state, a, p)
        single, ref = ttr.contrastive_train_step(model, single, a, p)
        assert torch.equal(loss, ref)
    got = _weights(state)
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())


def test_param_sharding_rules_place_the_jax_packages_shards(jax_run):
    """Each member's block of every parameter is, through the layout
    transposes, the JAX package's shard on the same mesh position."""
    cj, ct = _cfgs()
    model, state = jtr.create_train_state(cj, jax.random.PRNGKey(2), learning_rate=LR)
    jm = jmake_mesh(JMeshSpec(*SPEC))
    placed = jax.device_put(state.params, jtr._param_shardings(state.params, cj, jm))
    by_device = [{} for _ in range(8)]
    index = {d: m for m, d in enumerate(jm.devices.flat)}

    def collect(path, leaf):
        for shard in leaf.addressable_shards:
            node = by_device[index[shard.device]]
            for k in path[:-1]:
                node = node.setdefault(k.key, {})
            node[path[-1].key] = np.asarray(shard.data)

    jax.tree_util.tree_map_with_path(collect, placed)
    sharded, _ = _sharded(params_from_jax(_np(state.params)))
    rule = tenc.param_sharding_rules(ct)
    jrule = jenc.param_sharding_rules(cj)
    for m in range(8):
        want = params_from_jax(by_device[m])
        for name, t in sharded.params.items():
            assert torch.equal(t.blocks()[m], want[name]), (m, name)
    # the specs themselves, for the named layouts
    assert rule("layers.0.mlp_up.bias", torch.zeros(128)) == (None,)
    assert tuple(jrule("layer_0/mlp_up/bias", np.zeros(128))) == ()
    assert rule("layers.0.attn.query.bias", torch.zeros(64)) == ("tp",)
    assert tuple(jrule("layer_0/attn/query/bias", np.zeros((4, 16)))) == ("tp", None)


def test_params_actually_sharded():
    cj, ct = _cfgs(num_layers=1)
    _, state = jtr.create_train_state(cj, jax.random.PRNGKey(3))
    sharded, _ = _sharded(params_from_jax(_np(state.params)), cfg=ct)
    up = sharded.params["layers.0.mlp_up.weight"]
    assert {s.data.shape for s in up.addressable_shards} == {(64, 64)}  # 128 / tp 2
    assert sharded.params["layers.0.mlp_up.bias"].sharding.is_fully_replicated
    q = sharded.params["layers.0.attn.query.weight"]
    # one shard a tp coordinate, on the first member holding it, (0, t, 0)
    assert q.owners == {(0, 0): 0, (1, 0): 2}
    n_shards = sum(len(t.shards) for t in sharded.params.values())
    assert len(sharded.optimizer.param_groups[0]["params"]) == n_shards


def test_adamw_moments_are_carried_and_placed(jax_run):
    init = jax_run[0]
    a, p = _batch()
    model, single = ttr.create_train_state(_cfgs()[1], 0, learning_rate=LR, device="cpu",
                                           params=init)
    single, _ = ttr.contrastive_train_step(model, single, a, p)
    state, step = ttr.make_sharded_train_step(model, single, _mesh())
    for name, q in model.named_parameters():
        st = single.optimizer.state[q]
        t = state.params[name]
        for key, shard in t.shards.items():
            got = state.optimizer.state[shard]
            assert torch.equal(got["step"], st["step"]) and got["exp_avg"].shape == shard.shape
        moments = {k: torch.cat([state.optimizer.state[s][k].reshape(-1)
                                 for s in t.shards.values()]) for k in ("exp_avg", "exp_avg_sq")}
        if len(t.shards) == 1:
            assert torch.equal(moments["exp_avg"], st["exp_avg"].reshape(-1))
    state, loss = step(state, a, p)
    single, ref = ttr.contrastive_train_step(model, single, a, p)
    assert abs(float(loss) - float(ref)) <= 1e-5 and state.step == single.step == 2


def test_sizes_that_do_not_divide_raise(jax_run):
    init = jax_run[0]
    with pytest.raises(ValueError, match="num_heads 4 does not divide by tp=8"):
        _sharded(init, (1, 8, 1))
    _, ct = _cfgs(num_heads=2, mlp_dim=96, hidden_size=48)
    model, state = ttr.create_train_state(ct, 0, device="cpu")
    with pytest.raises(ValueError, match="does not divide by tp=4"):
        ttr.make_sharded_train_step(model, state, _mesh((1, 4, 2)))
    state, step = _sharded(init)
    a, p = _batch()
    with pytest.raises(ValueError, match="batch 3 does not divide by dp=2"):
        step(state, a[:3], p[:3])
    with pytest.raises(ValueError, match="sequence 29 does not divide by sp=2"):
        step(state, a[:, :29], p[:, :29])
    kernel = dataclasses.replace(_cfgs()[1], use_flash_attention=True)
    with pytest.raises(ValueError, match="einsum attention"):
        ttr.make_sharded_train_step(tenc.Encoder(kernel), state, _mesh())


@pytest.mark.parametrize("spec", [SPEC, (8, 1, 1)])
def test_the_encoder_takes_the_ring_with_a_mesh_attached(jax_run, spec):
    """``cfg.mesh`` with sp > 1 routes attention through the ring, as the
    reference's; with sp 1 the einsum branch, never the kernel."""
    init = jax_run[0]
    cj, ct = _cfgs()
    jm = jmake_mesh(JMeshSpec(*spec))
    a, _ = _batch(5)
    _, state = jtr.create_train_state(cj, jax.random.PRNGKey(2))
    want = np.asarray(jenc.Encoder(dataclasses.replace(cj, mesh=jm)).apply(
        {"params": state.params}, jnp.asarray(a)))
    model = tenc.Encoder(dataclasses.replace(ct, mesh=_mesh(spec), use_flash_attention=True))
    model.load_state_dict(init)
    with torch.no_grad():
        got = model(torch.from_numpy(a).long())
        plain = tenc.Encoder(dataclasses.replace(ct, use_flash_attention=False))
        plain.load_state_dict(init)
        dense = plain(torch.from_numpy(a).long())
    assert np.abs(got.numpy() - want).max() <= 1e-5
    if spec[2] == 1:
        assert torch.equal(got, dense)
    else:
        assert (got - dense).abs().max() <= 1e-5
