"""The port's multi-process helpers (``nornicdb_tpu_torch/parallel/multihost.py``)
against the JAX package's (``tests/test_multihost.py``): the JAX package
over ``tests/conftest.py``'s eight CPU devices, the port over eight CPU
members; and the process axis itself, two processes under gloo against one
process of two members.

Tolerances: the dp-over-dcn step's losses and weights within 1e-6 relative
of the JAX package's (float32 sums in another order); two processes
bitwise one process of two members (each sum adds the same two numbers)."""

import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.parallel import multihost as jmh
from nornicdb_tpu_torch.parallel import collectives as coll
from nornicdb_tpu_torch.parallel import mesh as tmesh
from nornicdb_tpu_torch.parallel import multihost as tmh

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-6
PROCESS_LIMIT_S = 120.0  # each spawned process's join limit


def _data(rows=8, width=4):
    x = np.random.default_rng(0).standard_normal((rows, width)).astype(np.float32)
    y = np.random.default_rng(1).standard_normal((rows, width)).astype(np.float32)
    return x, y


def dp_step(mesh, w, x, y, lr=0.1):
    """The reference test's data-parallel step on the port: loss
    ``mean((x @ w - y) ** 2)`` over the global batch, ``w`` replicated,
    ``x``/``y`` over ``dcn``; the per-member sums are ``psum``-ed over
    ``dcn`` and SGD updates ``w``'s shard in place. Returns the loss."""
    parts = [((xm @ wm - ym) ** 2).sum()
             for xm, wm, ym in zip(x.blocks(), w.blocks(), y.blocks())]
    loss = coll.psum(mesh, parts, "dcn")[0] / (x.shape[0] * x.shape[1])
    loss.backward()
    with torch.no_grad():
        for s in w.shards.values():
            s -= lr * s.grad
            s.grad = None
    return loss.detach()


def dp_run(mesh, x_local, y_local, width=4):
    """Two steps from ``w = 1``: (l0, l1, w after both)."""
    w = tmh.replicate_to_mesh(mesh, np.ones((width, width), np.float32)).requires_grad_()
    x = tmh.process_local_batch(mesh, x_local)
    y = tmh.process_local_batch(mesh, y_local)
    l0 = dp_step(mesh, w, x, y)
    l1 = dp_step(mesh, w, x, y)
    return float(l0), float(l1), w.shards[(0, 0)].detach().numpy().copy(), w


def _dp_process(rank, port, queue):
    """One of two processes: its own rows, one member, the group on gloo."""
    import torch.distributed as dist

    try:
        with tmesh.member_devices([CPU]):
            info = tmh.init_distributed(f"127.0.0.1:{port}", 2, rank)
            mesh = tmh.hybrid_mesh({})
            x, y = _data()
            l0, l1, w, _ = dp_run(mesh, x[rank * 4:(rank + 1) * 4], y[rank * 4:(rank + 1) * 4])
            queue.put((rank, info, dict(mesh.shape), (l0, l1, w)))
    except BaseException as exc:  # the test reports what failed in the child
        queue.put((rank, repr(exc), None, None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_distributed_single_process_noop():
    want = jmh.init_distributed()
    with tmesh.member_devices([CPU] * 8):
        info = tmh.init_distributed()
    assert set(info) == set(want)
    assert info == {"process_index": 0, "process_count": 1, "local_device_count": 8,
                    "global_device_count": 8}
    assert want["process_count"] == 1 and want["global_device_count"] >= 8


def test_init_distributed_reads_the_reference_variables(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:4321")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with tmesh.member_devices([CPU] * 2):
        tmh.init_distributed()
        tmh.init_distributed("10.0.0.1:99", 4, 1)
    assert calls == [("gloo", {"init_method": "tcp://127.0.0.1:4321", "world_size": 3, "rank": 2}),
                     ("gloo", {"init_method": "tcp://10.0.0.1:99", "world_size": 4, "rank": 1})]


def test_hybrid_mesh_axes_and_sizes():
    want = jmh.hybrid_mesh({"tp": 2, "sp": 2})
    with tmesh.member_devices([CPU] * 8):
        mesh = tmh.hybrid_mesh({"tp": 2, "sp": 2})
        assert mesh.axis_names == tuple(want.axis_names) == ("dcn", "tp", "sp")
        assert mesh.shape == dict(want.shape) == {"dcn": 2, "tp": 2, "sp": 2}
        assert mesh.process_axis == "dcn" and not mesh.in_process_group
        assert tmh.hybrid_mesh({"tp": 4}).shape == dict(jmh.hybrid_mesh({"tp": 4}).shape)
        with pytest.raises(ValueError, match="do not divide"):
            tmh.hybrid_mesh({"tp": 3})
    with pytest.raises(ValueError, match="do not divide"):
        jmh.hybrid_mesh({"tp": 3})


def test_process_local_batch_shards_over_dcn():
    local = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    with tmesh.member_devices([CPU] * 8):
        mesh = tmh.hybrid_mesh({"tp": 2, "sp": 2})
        arr = tmh.process_local_batch(mesh, local)
    want = jmh.process_local_batch(jmh.hybrid_mesh({"tp": 2, "sp": 2}), local)
    assert arr.shape == want.shape == (8, 4)
    assert arr.sharding.spec == ("dcn", None) and tuple(want.sharding.spec) == ("dcn", None)
    np.testing.assert_array_equal(np.asarray(arr), local)
    got = [s.data.numpy() for s in arr.addressable_shards]
    for m, shard in enumerate(want.addressable_shards):
        np.testing.assert_array_equal(got[m], np.asarray(shard.data))
    assert len(arr.shards) == 2 and arr.owners == {(0, 0): 0, (1, 0): 4}


def test_replicate_to_mesh_holds_one_shard():
    with tmesh.member_devices([CPU] * 8):
        mesh = tmh.hybrid_mesh({"tp": 2, "sp": 2})
        w = tmh.replicate_to_mesh(mesh, np.eye(3, dtype=np.float32))
    assert w.sharding.is_fully_replicated and list(w.shards) == [(0, 0)]
    assert all(torch.equal(b, torch.eye(3)) for b in w.blocks())


def test_dp_over_dcn_gradient_step_matches_jax():
    x, y = _data()
    jmesh = jmh.hybrid_mesh({"tp": 2, "sp": 2})
    w = jmh.replicate_to_mesh(jmesh, np.ones((4, 4), np.float32))
    jx, jy = jmh.process_local_batch(jmesh, x), jmh.process_local_batch(jmesh, y)

    @jax.jit
    def step(w, x, y):
        def loss(w):
            return jnp.mean((x @ w - y) ** 2)

        return w - 0.1 * jax.grad(loss)(w), loss(w)

    w2, jl0 = step(w, jx, jy)
    w3, jl1 = step(w2, jx, jy)
    with tmesh.member_devices([CPU] * 8):
        mesh = tmh.hybrid_mesh({"tp": 2, "sp": 2})
        l0, l1, w_final, sharded = dp_run(mesh, x, y)
    assert l1 < l0
    assert abs(l0 - float(jl0)) <= RTOL * abs(float(jl0))
    assert abs(l1 - float(jl1)) <= RTOL * abs(float(jl1))
    np.testing.assert_allclose(w_final, np.asarray(w3), rtol=RTOL, atol=RTOL)
    # the updated weights stay replicated
    assert sharded.sharding.is_fully_replicated and w3.sharding.is_fully_replicated


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_under_gloo_equal_one_process_bitwise():
    """The process axis crossed for real: two spawned processes, one member
    and half the rows each, ``init_distributed`` on gloo; their losses and
    weights equal one process's two-member run bitwise. Each process is
    joined with a limit and killed past it, so the test fails, not hangs."""
    x, y = _data()
    with tmesh.member_devices([CPU] * 2):
        mesh = tmh.hybrid_mesh({})
        want = dp_run(mesh, x, y)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dp_process, args=(rank, port, queue)) for rank in range(2)]
    for p in procs:
        p.start()
    try:
        results = {}
        for _ in procs:
            rank, info, shape, got = queue.get(timeout=PROCESS_LIMIT_S)
            results[rank] = (info, shape, got)
    finally:
        for p in procs:
            p.join(timeout=PROCESS_LIMIT_S)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in procs)
    for rank, (info, shape, got) in sorted(results.items()):
        assert got is not None, info
        assert info == {"process_index": rank, "process_count": 2, "local_device_count": 1,
                        "global_device_count": 2}
        assert shape == {"dcn": 2}
        assert got[0] == want[0] and got[1] == want[1] and want[1] < want[0]
        assert np.array_equal(got[2], want[2])
    assert [p.exitcode for p in procs] == [0, 0]


@pytest.mark.parametrize("params,dtype_bytes,dcn", [(100_000_000, 4, 4), (567_000_000, 2, 2),
                                                    (1_000, 4, 1)])
def test_capacity_planning_helper(params, dtype_bytes, dcn):
    got = tmh.dcn_allreduce_bytes_per_step(params, dtype_bytes=dtype_bytes, dcn_size=dcn)
    assert got == jmh.dcn_allreduce_bytes_per_step(params, dtype_bytes=dtype_bytes,
                                                    dcn_size=dcn)
    assert got[0] == int(2 * (dcn - 1) / dcn * params * dtype_bytes) and "MB/host/step" in got[1]
