"""The port's ring attention (``nornicdb_tpu_torch/parallel/ring_attention.py``)
against the JAX package's (``tests/test_models.py::TestRingAttention``), the
JAX package over ``tests/conftest.py``'s eight CPU devices, the port over
``member_devices`` of CPU members.

Tolerances: float32 outputs and gradients within 1e-5 of the JAX package's
and of the dense path (sums in another order); a bf16 ``q`` within one
bf16 rounding of outputs below 4 (1.6e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.parallel import ring_attention as jring
from nornicdb_tpu.parallel.mesh import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from nornicdb_tpu_torch.parallel import mesh as tmesh
from nornicdb_tpu_torch.parallel.mesh import Mesh, _device_array
from nornicdb_tpu_torch.parallel.ring_attention import _dense_attention, ring_attention

torch.set_num_threads(1)

ATOL = 1e-5
BF16_ATOL = 1.6e-2
CPU = torch.device("cpu")
MASKS = ["keep_0.8", "first_block"]


def _inputs(seed, shape, mask_kind, sp):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    b, s = shape[:2]
    if mask_kind == "keep_0.8":
        mask = rng.random((b, s)) > 0.2
    else:  # only the first member's keys are valid
        mask = np.zeros((b, s), bool)
        mask[:, :s // sp] = True
    return q, k, v, mask


def _sp_meshes(sp):
    return (Mesh(_device_array([CPU] * sp, (sp,)), ("sp",)),
            jax.sharding.Mesh(np.array(jax.devices()[:sp]), ("sp",)))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_matches_jax_and_dense(sp, mask_kind):
    q, k, v, mask = _inputs(sp, (2, 64, 4, 16), mask_kind, sp)
    tm, jm = _sp_meshes(sp)
    want = np.asarray(jring.ring_attention(*_j(q, k, v, mask), mesh=jm, axis_name="sp"))
    got = ring_attention(*_t(q, k, v, mask), mesh=tm, axis_name="sp")
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert np.abs(got.numpy() - want).max() <= ATOL
    dense = _dense_attention(*_t(q, k, v, mask))
    assert (got - dense).abs().max() <= ATOL


@pytest.mark.parametrize("mask_kind", MASKS)
def test_no_mesh_and_an_axis_of_one_take_the_dense_path(mask_kind):
    q, k, v, mask = _inputs(4, (2, 16, 4, 8), mask_kind, 2)
    want = np.asarray(jring._dense_attention(*_j(q, k, v, mask)))
    dense = _dense_attention(*_t(q, k, v, mask))
    assert np.abs(dense.numpy() - want).max() <= ATOL
    assert torch.equal(ring_attention(*_t(q, k, v, mask)), dense)
    one, _ = _sp_meshes(1)
    assert torch.equal(ring_attention(*_t(q, k, v, mask), mesh=one), dense)
    if mask_kind == "keep_0.8":  # no mask: every key valid
        assert torch.equal(ring_attention(*_t(q, k, v)),
                           _dense_attention(*_t(q, k, v), torch.ones(2, 16, dtype=torch.bool)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_ring_with_batch_and_head_axes_on_a_dp_tp_sp_mesh(mask_kind):
    q, k, v, mask = _inputs(7, (4, 32, 4, 8), mask_kind, 2)
    jm = jmake_mesh(JMeshSpec(dp=2, tp=2, sp=2))
    want = np.asarray(jring.ring_attention(*_j(q, k, v, mask), mesh=jm, axis_name="sp",
                                           batch_axis="dp", head_axis="tp"))
    with tmesh.member_devices([CPU] * 8):
        tm = tmesh.make_mesh(tmesh.MeshSpec(dp=2, tp=2, sp=2))
        got = ring_attention(*_t(q, k, v, mask), mesh=tm, axis_name="sp",
                             batch_axis="dp", head_axis="tp")
    assert np.abs(got.numpy() - want).max() <= ATOL


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("sp", [2, 8])
def test_ring_gradients_match_jax(sp, mask_kind):
    q, k, v, mask = _inputs(10 + sp, (2, 32, 2, 8), mask_kind, sp)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    tm, jm = _sp_meshes(sp)

    def f(q, k, v):
        return jnp.sum(jring.ring_attention(q, k, v, jnp.asarray(mask), mesh=jm) * w)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    (ring_attention(tq, tk, tv, torch.from_numpy(mask), mesh=tm) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq, tk, tv), want):
        assert np.abs(got.grad.numpy() - np.asarray(ref)).max() <= ATOL


def test_a_bf16_query_casts_the_output_back():
    q, k, v, mask = _inputs(21, (1, 32, 2, 16), "keep_0.8", 4)
    tm, jm = _sp_meshes(4)
    want = jring.ring_attention(jnp.asarray(q, jnp.bfloat16), *_j(k, v, mask), mesh=jm)
    got = ring_attention(torch.from_numpy(q).bfloat16(), *_t(k, v, mask), mesh=tm)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() <= BF16_ATOL


def test_a_sequence_that_does_not_divide_raises():
    q, k, v, mask = _inputs(1, (1, 30, 2, 8), "keep_0.8", 4)
    tm, _ = _sp_meshes(4)
    with pytest.raises(ValueError, match="does not divide"):
        ring_attention(*_t(q, k, v, mask), mesh=tm)
